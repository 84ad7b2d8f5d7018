from .engine import GeoMapReduce, MRApp, PhaseStats
from .partition import bucket_owners, hash_keys
from . import apps

__all__ = ["GeoMapReduce", "MRApp", "PhaseStats", "bucket_owners", "hash_keys",
           "apps"]
