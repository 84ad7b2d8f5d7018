"""Geo-distributed Word Count through the PyTorch port's ``GeoJob``
(``repro_torch``; no jax).

Runs the paper's Word Count application (in-mapper combining, the reduce
a ``segment_sum`` on ``--device``: the hand-written CUDA kernel on the
card) over an 8-data-center platform under three execution plans, the
Fig-9 experiment in miniature.  ``calibrate`` probe-measures the app's
real expansion factor α and input volumes, ``plan`` optimizes against
them on ``--device``, and ``execute`` prices the *measured* byte movement
through the same cost model the planner used.

    PYTHONPATH=src python examples/port_wordcount.py
    PYTHONPATH=src python examples/port_wordcount.py --device cpu
"""
import argparse

from repro_torch.api import GeoJob, split_sources
from repro_torch.core import BARRIERS_GGL, local_push_plan, planetlab_platform, uniform_plan
from repro_torch.mapreduce.apps import generate_documents, word_count

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda or cpu")
args = ap.parse_args()

keys, vals = generate_documents(n_docs=800, words_per_doc=60, seed=0)
base = planetlab_platform(8, alpha=1.0, seed=0)
sources = split_sources(keys, vals, base.nS)

# probe-measure the app's real expansion factor, then plan with it
job = GeoJob(base, word_count(device=args.device),
             device=args.device).calibrate(sources)
print(f"measured alpha = {job.platform.alpha:.3f} "
      f"(paper's WordCount: 0.09 — heavy aggregation)")

setups = {
    "uniform": lambda: job.with_plan(uniform_plan(job.platform), BARRIERS_GGL),
    "hadoop-locality": lambda: job.with_plan(local_push_plan(job.platform), BARRIERS_GGL),
    "optimized": lambda: job.plan("e2e_multi", barriers=BARRIERS_GGL),
}
reports = {}
for name, setup in setups.items():
    setup()
    reports[name] = job.execute(sources)
    n_words = sum(len(k) for k, _ in reports[name].outputs)
    print(f"{name:16s} {reports[name].summary()}  ({n_words} unique words)")

red = 1 - (reports["optimized"].makespan_measured
           / reports["hadoop-locality"].makespan_measured)
print(f"\noptimized plan beats the Hadoop-locality baseline by {red:.0%} "
      f"(paper: 36% for WordCount)")
