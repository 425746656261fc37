"""The check's control and its faults.

The control, the reference in bfloat16 put in the program's place, has to
fail every cell's limits. Each fault that a cell can have, planted in the
timed path under a run of the harness on the CPU, has to make the run come
out not correct: an update that returns the state unchanged; half of each
pass's pixels left out and the mean of the rest put in their place; an
answer altered where it is produced (every 8th pixel's radiance
doubled). The exchange between chips is a fault no cell can
have: every cell takes one chip. The control at a cell's own size runs on
the card (``cuda`` mark)."""
import pytest
import torch

from portbench import check, control, manifest, run

CELLS = ("hero.final-1080p", "mesh100k.final-4k", "mesh100k.preview-1080p")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_small(cell):
    nums = control.readings(cell, 1234567, 10, device="cpu", frame=(16, 16),
                            pixels=256)
    assert not check.judge(nums, manifest.Manifest().check(cell)["limits"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(card, cell):
    for seed in (11, 2 ** 31 + 5, 987654321):
        nums = control.readings(cell, seed, 20, device=card)
        assert not check.judge(nums, manifest.Manifest().check(cell)[
            "limits"]), (seed, nums)


def _noop(scene, policy, state, width, height, n):
    return state


def _half_left_out(render_pass):
    def broken(scene, policy, accumulation, width, height, *a, **kw):
        rad, count = render_pass(scene, policy, accumulation, width, height,
                                 *a, **kw)
        out = []
        for c in rad:
            c = c.clone()
            kept = c[..., 0::2]
            c[..., 1::2] = kept.mean(dim=-1, keepdim=True)
            out.append(c)
        return type(rad)(*out), count
    return broken


def _answer_altered(render_pass):
    def broken(scene, policy, accumulation, width, height, *a, **kw):
        rad, count = render_pass(scene, policy, accumulation, width, height,
                                 *a, **kw)
        out = []
        for c in rad:
            c = c.clone()
            c[..., ::8] *= 2.0
            out.append(c)
        return type(rad)(*out), count
    return broken


@pytest.mark.parametrize("fault", ["sound", "noop", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_planted_faults_come_out_not_correct(monkeypatch, cell, fault):
    """16x16 frames, at least 5 passes, so that every bucket holds one."""
    from cpu_raytracing_experiments_tpu_torch.render import (estimator,
                                                             renderer)

    if fault == "noop":
        monkeypatch.setattr(estimator, "accumulate_n", _noop)
    elif fault == "half":
        monkeypatch.setattr(renderer, "render_pass",
                            _half_left_out(renderer.render_pass))
    elif fault == "altered":
        monkeypatch.setattr(renderer, "render_pass",
                            _answer_altered(renderer.render_pass))
    mf = manifest.Manifest()
    k = mf.traffic(mf.workload(cell)["traffic"])["passes_per_update"]
    out = run.run_cell(cell, 424242, 1e9, False, device="cpu",
                       frame=(16, 16), max_updates=-(-5 // k))
    assert out.result["correct"] == (fault == "sound"), out.numbers
