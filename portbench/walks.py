"""Operations and bytes of the cluster walks (csrc/cluster_traverse.cu's
closest_kernel and occluded_kernel templates), for their roofline.

The port counts a walk call's work on its ``port.walk`` span while a
profiler session records: ``walk_pairs``, the (valid ray, real prim) pairs
the walk needs (the closest walk every ray against every real prim of a
visited cluster, the any-hit walk a ray not yet occluded up to and
including its first occluder), and ``walk_rays``, the rays it was given;
the span's attributes say which walk ran (``walk_form``, ``walk_kind``,
``walk_prims``)."""
from __future__ import annotations

# float32 operations of one (ray, prim) pair, by (prims, walk kind): the
# counts of PERF.md's kernel table
PAIR_OPS = {("triangle", "closest"): 38, ("triangle", "anyhit"): 39,
            ("sphere", "closest"): 20, ("sphere", "anyhit"): 19}

# bytes of one ray read and written once: the closest walk reads origin,
# direction and tfar0 (28) and the valid byte and writes tfar and the prim
# id (8); the any-hit walk reads origin, direction and tfar (28) and writes
# the occlusion byte
RAY_BYTES = {"closest": 28 + 1 + 8, "anyhit": 28 + 1}


def walk_call(prims: str, kind: str, pairs: int, rays: int) -> tuple:
    """(operations, bytes) of one walk call. A cluster's rows are not
    counted a visit: the tiles that visit a cluster read it again from
    L2, so the bytes the walk must move are its rays' once."""
    return pairs * PAIR_OPS[prims, kind], rays * RAY_BYTES[kind]


def walk_spans(recs: list, form: str) -> list:
    """The ``port.walk`` records of walk form `form` that carry the
    counters (none where the program counts nothing)."""
    return [r for r in recs if r["name"] == "port.walk"
            and r["attrs"].get("walk_form") == form
            and "walk_pairs" in r["counts"] and "walk_rays" in r["counts"]]
