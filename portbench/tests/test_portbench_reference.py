"""The reference against the port's CPU path on small frames of each
configuration, and the benchmark's scene arrays against the port's own
builders (the configurations' sources)."""
import numpy as np
import pytest
import torch

from portbench import check, manifest, run, scenes
from portbench.reference import pathtrace

CELLS = ("hero.final-1080p", "mesh100k.final-4k", "mesh100k.preview-1080p")


@pytest.mark.parametrize("name,build", [
    ("hero", lambda b, w, h: b.default_scene(w, h)),
    ("mesh100k", lambda b, w, h: b.mesh_scene(w, h, uv_res=224)),
])
def test_scene_arrays_equal_the_ports_builders(name, build):
    from cpu_raytracing_experiments_tpu_torch.scene import builders

    mine = scenes.port_arrays(scenes.build(manifest.Manifest().config(name),
                                           40, 24))
    theirs = build(builders, 40, 24).to_numpy()
    keys = {k for k in theirs if not k.startswith("light_alias")}
    assert set(mine) == keys
    for k in keys:
        a, b = np.asarray(mine[k]), np.asarray(theirs[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_ports_cpu_path(cell):
    """16x16 frames, at least 5 passes (every bucket filled): every
    compared number within the cell's limit."""
    mf = manifest.Manifest()
    k = mf.traffic(mf.workload(cell)["traffic"])["passes_per_update"]
    out = run.run_cell(cell, 2 ** 31 + 77, 1e9, False, device="cpu",
                       frame=(16, 16), max_updates=-(-5 // k))
    assert out.result["correct"]
    for name in check.NAMES:
        assert out.numbers[name] <= out.limits[name], (name, out.numbers)


def test_resolve_is_median_of_bucket_means_then_aces():
    b = torch.tensor([[[1.0], [2.0], [3.0]]] * 5) * torch.arange(
        1, 6, dtype=torch.float32)[:, None, None]
    img = pathtrace.resolve(b, 10, 1)
    lin = torch.tensor([3.0, 6.0, 9.0]) / 2  # median bucket / 2 rounds
    assert img.shape == (1, 3)
    assert torch.all(img > 0) and torch.all(img <= 1)
    dark = pathtrace.resolve(b * 0, 10, 1)
    assert torch.all(dark == 0)
    assert float(lin.max()) == 4.5


def test_u32_arithmetic_wraps():
    a = torch.tensor([0xFFFFFFFF, 12345], dtype=torch.int64)
    assert pathtrace.mul32(a, 0xFFFFFFFF).tolist() == [
        (0xFFFFFFFF * 0xFFFFFFFF) & 0xFFFFFFFF, (12345 * 0xFFFFFFFF)
        & 0xFFFFFFFF]
    assert pathtrace.bitreverse32(torch.tensor([1])).item() == 1 << 31
