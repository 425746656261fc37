"""Host seconds of the scene's acceleration build in set-up: the cluster
build (scene/accel.py::with_pallas_clusters, csrc/bvh_builder.cpp) and the
Renderer's move of the scene to the card with its streamed tables
(intersect.prepare_stream). None where the configuration builds none."""


def read(ctx):
    return ctx.spans.get("accel_build_s")
