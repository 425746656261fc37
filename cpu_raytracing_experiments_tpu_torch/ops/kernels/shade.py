"""The lambertian hit shading of one bounce in two launches: the card's form
of ``render/renderer.py::bounce_step`` around NEE where
``renderer.shade_kernel_path`` holds (``csrc/shade.cu``).

``shade_frame`` takes the intersection's answer and the state's rays and
returns what NEE and the tail read: (hit, p_offset, the tangent quat,
albedo, material id), bit for bit ``_closest_hit_frame`` and
``_gather_material``. ``shade_tail`` takes them with the radiance NEE left,
NEE's shadow rays and the BSDF site's draws, and returns the next
``PathState``'s columns and the ray counts, bit for bit the plain path's
emissive hit, lambertian sample, Russian roulette, sky and writeback. Both
read the scene through ``scene_columns``. It replaces no Pallas kernel: the
JAX package leaves this shading to XLA's fusion.

The wrappers launch the kernels for CUDA tensors or raise ``ValueError``;
nothing falls back. The renderer decides which path shades a bounce
(``renderer.shade_kernel_path``). Launches are counted in ``FRAME`` and
``TAIL``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ...core.vec import Quat, Vec3
from . import build, lanes
from .build import LaunchCounter

FRAME = LaunchCounter("shade_frame")
TAIL = LaunchCounter("shade_tail")
FRAME_ROWS = 9  # p_offset x y z, the quat's x y w, albedo x y z
TAIL_ROWS = 10  # p x y z, d x y z, throughput x y z, prev_pdf
# csrc/shade.cu's Flag bits
USE_MIS, ROULETTE, SKY_COMPAT, LAST = 1, 2, 4, 8


def _bind(lib: ctypes.CDLL):
    ptr, i64, u32, i32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint,
                          ctypes.c_int)
    lib.shade_frame.argtypes = [ptr, ptr, ptr, i64, ptr, ptr, i64, i64, i32,
                                ptr]
    lib.shade_frame.restype = i32
    lib.shade_tail.argtypes = [ptr, ptr, ptr, i64, u32, ctypes.c_float, ptr,
                               i64, ptr, i64, ptr, ptr, ptr, ptr, i64, i64,
                               i32, ptr]
    lib.shade_tail.restype = i32


LIBRARY = build.Library("shade.cu", build.nvcc, build.NVCC_FLAGS, _bind,
                        headers=("lanes.cuh",))


class SceneColumns(NamedTuple):
    """The scene's column addresses in ``csrc/shade.cu``'s SceneCol order
    and the card they lie on."""

    addrs: ctypes.Array
    device: torch.device


_SCENES = lanes.Derived()  # SceneColumns by the columns they address


def _one_device(name, cols, device):
    for k, x in enumerate(cols):
        if not x.is_cuda or x.device != device:
            raise ValueError(f"scene_columns: {name} column {k} is on "
                             f"{x.device}, not on {device}")


def scene_columns(spheres, triangles, materials, sky) -> SceneColumns:
    """The columns both kernels read: the spheres' centers, r^2 and material
    ids, the triangles' normals and material ids (none where `triangles` is
    None), the materials' albedo and emission, the sky's texel planes (the
    kernels read texel 0: a 1x1 map) and its 0-d ambient tint; all on one
    card. Checked once for a given set of columns (``lanes.Derived``);
    raises ValueError."""
    tri = ((*triangles.normal, triangles.material_id)
           if triangles is not None else ())
    groups = (("sphere", (*spheres.center, spheres.radius_sq,
                          spheres.material_id),
               (torch.float32,) * 4 + (torch.int32,)),
              ("triangle", tri, (torch.float32,) * 3 + (torch.int32,)),
              ("material", (*materials.albedo, *materials.emission),
               (torch.float32,) * 6))
    sky_cols = (sky.hdri_r, sky.hdri_g, sky.hdri_b, *sky.ambient)
    for k, x in enumerate(sky_cols):
        if (not isinstance(x, torch.Tensor) or x.dtype != torch.float32
                or x.numel() < 1 or not x.is_contiguous()):
            raise ValueError(f"scene_columns: sky column {k} is no "
                             "contiguous float32 tensor of a texel or more")

    def check():
        addrs = []
        device = None
        for name, cols, dtypes in groups:
            if not cols:
                addrs += [0] * len(dtypes)
                continue
            ptrs, n, dev = lanes.columns(f"scene_columns: {name}", cols,
                                         dtypes)
            if n < 1 and name != "triangle":  # sphere 0 and a material
                raise ValueError(f"scene_columns: no {name}")
            device = device or dev
            _one_device(name, cols, device)
            addrs += ptrs
        _one_device("sky", sky_cols, device)
        addrs += [x.data_ptr() for x in sky_cols]
        return SceneColumns((ctypes.c_ulonglong * len(addrs))(*addrs),
                            device)

    return _SCENES.get([c for _, cols, _ in groups for c in cols]
                       + list(sky_cols), check)


def _same_card(name: str, scene: SceneColumns, device):
    if scene.device != device:
        raise ValueError(f"{name}: the scene is on {scene.device}, the lanes "
                         f"on {device}")


def shade_frame(alive, prim_id, is_tri, tfar, p: Vec3, d: Vec3,
                scene: SceneColumns):
    """The closest-hit frame of the lanes of `alive` (bool [R]), `prim_id`
    (int32), `is_tri` (bool), `tfar` and the rays `p`, `d` (float32
    columns): one launch of ``csrc/shade.cu``. Returns (hit bool [R],
    p_offset Vec3, the tangent quat (x, y, w; its z is 0 and left None),
    albedo Vec3, material id int32 [R]); past `hit` every column holds
    values at hit lanes only."""
    cols = (alive, prim_id, is_tri, tfar, *p, *d)
    dtypes = (torch.bool, torch.int32, torch.bool) + (torch.float32,) * 7
    ptrs, r, device = lanes.columns("shade_frame", cols, dtypes)
    _same_card("shade_frame", scene, device)
    out = lanes.rows(FRAME_ROWS, r, device)
    mat = torch.empty(r, dtype=torch.int32, device=device)
    hit = torch.empty(r, dtype=torch.bool, device=device)
    n_vec = lanes.groups(r, [ptrs[1], *ptrs[3:], out.data_ptr(),
                             mat.data_ptr()],
                         [ptrs[0], ptrs[2], hit.data_ptr()])
    addrs = (ctypes.c_ulonglong * len(ptrs))(*ptrs)
    build.launch(FRAME, LIBRARY.load().shade_frame, device,
                 [addrs, scene.addrs, out.data_ptr(), out.stride(0),
                  mat.data_ptr(), hit.data_ptr(), r, n_vec,
                  build.sm_count(device.index)])
    return (hit, Vec3(*out[0:3]), Quat(out[3], out[4], None, out[5]),
            Vec3(*out[6:9]), mat)


_SCRATCH = {}  # (card index, stream) -> the tail's three int64 zeros


def _scratch(device) -> torch.Tensor:
    """The tail's sums of one card and stream: zero between launches (the
    last block of a launch sets them back), so launches in turn on one
    stream share them and launches on two streams do not."""
    key = device.index, torch._C._cuda_getCurrentRawStream(device.index)
    s = _SCRATCH.get(key)
    if s is None:
        s = _SCRATCH[key] = torch.zeros(3, dtype=torch.int64, device=device)
    return s


class Tail(NamedTuple):
    """shade_tail's outputs: the next state's columns and the counts
    (int64 [3]: the new ray_count, the alive lanes, the shadow rays)."""

    p: Vec3
    d: Vec3
    throughput: Vec3
    radiance: Vec3
    prev_pdf: torch.Tensor
    prev_delta: torch.Tensor
    alive: torch.Tensor
    counts: torch.Tensor


def shade_tail(alive, hit, prim_id, is_tri, tfar, mat_id, t_quat,
               p_offset: Vec3, p: Vec3, d: Vec3, throughput: Vec3,
               radiance: Vec3, prev_pdf, prev_delta, valid, ray_count,
               draws: torch.Tensor, scene: SceneColumns, *, use_mis: bool,
               inv_l: float, roulette: bool, sky_compat: bool,
               last: bool) -> Tail:
    """The rest of a lambertian bounce after NEE, one launch of
    ``csrc/shade.cu``: the emissive hit (MIS against prev_pdf with the
    sphere pdf times `inv_l` where `use_mis`), the lambertian sample from
    the BSDF site's [3, R] `draws` (u, v, the roulette draw), Russian
    roulette where `roulette`, the constant sky (``sky_bug_compat`` where
    `sky_compat`), the writeback, no lane alive where `last`; `valid`
    (NEE's shadow rays, bool [R], or None) and the 0-d int64 `ray_count`
    give the new ray count. The lane columns are those ``shade_frame``
    returned and the state's; all on one card."""
    bools = (alive, hit, prev_delta) + (() if valid is None else (valid,))
    cols = (*bools, prim_id, is_tri, tfar, mat_id, t_quat.x, t_quat.y,
            t_quat.w, *p_offset, *p, *d, *throughput, *radiance, prev_pdf)
    dtypes = ((torch.bool,) * len(bools)
              + (torch.int32, torch.bool, torch.float32, torch.int32)
              + (torch.float32,) * 19)
    ptrs, r, device = lanes.columns("shade_tail", cols, dtypes)
    _same_card("shade_tail", scene, device)
    if (not isinstance(ray_count, torch.Tensor) or ray_count.dim() != 0
            or ray_count.dtype != torch.int64 or ray_count.device != device):
        raise ValueError("shade_tail: ray_count must be a 0-d int64 tensor "
                         f"on {device}")
    if (not isinstance(draws, torch.Tensor) or draws.device != device
            or draws.dtype != torch.float32 or draws.dim() != 2
            or draws.shape[0] < 3 or draws.shape[1] != r
            or draws.stride(1) != 1):
        raise ValueError(
            "shade_tail: draws must be [3, R] float32 rows on the lanes' "
            f"card with unit stride, R = {r}; got "
            f"{getattr(draws, 'dtype', type(draws))} "
            f"{tuple(getattr(draws, 'shape', ()))}")
    nb = len(bools)
    valid_ptr = ptrs[3] if valid is not None else 0
    # csrc/shade.cu's TailCol order
    addrs = [ptrs[0], ptrs[1], valid_ptr, ptrs[2], *ptrs[nb:],
             ray_count.data_ptr()]
    out = lanes.rows(TAIL_ROWS, r, device)
    rad = lanes.rows(3, r, device)
    alive_out = torch.empty(r, dtype=torch.bool, device=device)
    delta_out = torch.empty(r, dtype=torch.bool, device=device)
    counts = torch.empty(3, dtype=torch.int64, device=device)
    draw_ptr, draw_stride = draws.data_ptr(), draws.stride(0)
    n_vec = lanes.groups(
        r, [*ptrs[nb + 3:], *(draw_ptr + 4 * k * draw_stride
                              for k in range(3)),
            out.data_ptr(), rad.data_ptr()],
        [*ptrs[:nb], alive_out.data_ptr(), delta_out.data_ptr()])
    flags = ((USE_MIS if use_mis else 0) | (ROULETTE if roulette else 0)
             | (SKY_COMPAT if sky_compat else 0) | (LAST if last else 0))
    build.launch(TAIL, LIBRARY.load().shade_tail, device,
                 [(ctypes.c_ulonglong * len(addrs))(*addrs), scene.addrs,
                  draw_ptr, draw_stride, flags, inv_l, out.data_ptr(),
                  out.stride(0), rad.data_ptr(), rad.stride(0),
                  alive_out.data_ptr(), delta_out.data_ptr(),
                  counts.data_ptr(), _scratch(device).data_ptr(), r, n_vec,
                  build.sm_count(device.index)])
    return Tail(Vec3(*out[0:3]), Vec3(*out[3:6]), Vec3(*out[6:9]),
                Vec3(*rad), out[9], delta_out, alive_out, counts)
