from .pipeline import GeoDataPipeline, synthetic_lm_batch
from .tokenizer import ByteTokenizer

__all__ = ["GeoDataPipeline", "synthetic_lm_batch", "ByteTokenizer"]
