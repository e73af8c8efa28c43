"""Bytes of the tables the traced ticks' traversal engine reads, in MB (10^6
bytes), as the program counts them in the ``table_bytes`` attribute of its
``pbrt.tick`` span: for B1 its nodes, instance rows and leaf records, for
B2 those and its group boxes, prim ids and band pairs. Against the H100's
50 MB L2 it says whether a cell's traversal can stay in the cache. A program
that does not count them gives None."""

from pbrt_bench.harness import load_module


def read(run):
    spans = load_module("metrics", "spans")
    ticks = [r for t in spans.trees(run, "frame") or () for r in t if r["name"] == "pbrt.tick"
             and "table_bytes" in r["attrs"]]
    if not ticks:
        return None
    return sum(r["attrs"]["table_bytes"] for r in ticks) / len(ticks) / 1e6
