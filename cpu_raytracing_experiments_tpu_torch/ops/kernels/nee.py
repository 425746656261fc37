"""Next-event estimation toward sphere lights in two launches: the card's
form of ``render/renderer.py::_next_event_estimation`` under the lambertian
closure with MIS, the uniform light pick and sphere lights only
(``csrc/nee.cu``).

``nee_sphere`` takes the bounce's closest-hit state, the NEE site's three
draws (``core/rng.py::site_draws``) and the scene's packed light table, and
returns what the shadow query reads and what the radiance gains:
(l_dir, tfar, valid, shadow radiance), bit for bit the plain path's.
``nee_combine`` adds the shadow radiance of the lanes that are valid and
not occluded to the radiance. Between them ``ops/intersect.py::
occluded_scene`` runs unchanged. It replaces no Pallas kernel: the JAX
package leaves NEE to XLA's fusion.

The wrappers launch the kernels for CUDA tensors or raise ``ValueError``;
nothing falls back. The renderer decides which path shades a bounce
(``renderer.nee_kernel_path``). Launches are counted in ``SPHERE`` and
``COMBINE``.
"""
from __future__ import annotations

import ctypes

import torch

from ...core.vec import Vec3
from . import build, lanes
from .build import LaunchCounter

SPHERE = LaunchCounter("nee_sphere")
COMBINE = LaunchCounter("nee_combine")
ROW = 8  # a light's row: prim id, center x y z, r^2, emission x y z
OUT_ROWS = 7  # l_dir x y z, tfar, shadow radiance x y z


def _bind(lib: ctypes.CDLL):
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.nee_sphere.argtypes = [ptr, ptr, i64, ptr, i32, ptr, i64, ptr, i64,
                               i64, i32, ptr]
    lib.nee_sphere.restype = i32
    lib.nee_combine.argtypes = [ptr, ptr, i64, i64, i64, i32, ptr]
    lib.nee_combine.restype = i32


LIBRARY = build.Library("nee.cu", build.nvcc, build.NVCC_FLAGS, _bind,
                        headers=("lanes.cuh",))


def nee_sphere(hit, prim_id, is_tri, p_offset: Vec3, t_quat, albedo: Vec3,
               throughput: Vec3, draws: torch.Tensor, lights: torch.Tensor):
    """NEE toward the sphere lights of the [L, 8] table `lights` (prim id,
    center, r^2, emission; float32) for the lanes of `hit` (bool [R]),
    `prim_id` (int32), `is_tri` (bool) and the float32 columns of
    `p_offset`, the tangent quat `t_quat` (x, y and w; z is 0), `albedo`
    and `throughput`; `draws` the NEE site's [3, R] float32 rows (t, s,
    the selection draw). One launch of ``csrc/nee.cu``. Returns (l_dir
    Vec3, tfar, valid bool [R], shadow radiance Vec3): l_dir zero where the
    sample is not ok, tfar and the shadow radiance zero where not valid."""
    floats = (*p_offset, t_quat.x, t_quat.y, t_quat.w, *albedo, *throughput)
    cols = (hit, prim_id, is_tri, *floats)
    dtypes = ((torch.bool, torch.int32, torch.bool)
              + (torch.float32,) * len(floats))
    ptrs, r, device = lanes.columns("nee_sphere", cols, dtypes)
    if (not isinstance(draws, torch.Tensor) or not draws.is_cuda
            or draws.device != device or draws.dtype != torch.float32
            or draws.dim() != 2 or draws.shape[0] < 3
            or draws.shape[1] != r or draws.stride(1) != 1):
        raise ValueError(
            "nee_sphere: draws must be [3, R] float32 rows on the lanes' "
            f"card with unit stride, R = {r}; got "
            f"{getattr(draws, 'dtype', type(draws))} "
            f"{tuple(getattr(draws, 'shape', ()))}")
    if (not isinstance(lights, torch.Tensor) or lights.device != device
            or lights.dtype != torch.float32 or lights.dim() != 2
            or lights.shape[0] < 1 or lights.shape[1] != ROW
            or not lights.is_contiguous() or lights.data_ptr() % 16):
        raise ValueError(
            f"nee_sphere: lights must be a contiguous [L, {ROW}] float32 "
            "table of at least one light on the lanes' card; got "
            f"{getattr(lights, 'dtype', type(lights))} "
            f"{tuple(getattr(lights, 'shape', ()))}")
    out = lanes.rows(OUT_ROWS, r, device)
    valid = torch.empty(r, dtype=torch.bool, device=device)
    draw_ptr, draw_stride = draws.data_ptr(), draws.stride(0)
    draw_rows = [draw_ptr + 4 * k * draw_stride for k in range(3)]
    n_vec = lanes.groups(r, [*ptrs[3:], ptrs[1], *draw_rows, out.data_ptr()],
                         [ptrs[0], ptrs[2], valid.data_ptr()])
    addrs = (ctypes.c_ulonglong * len(ptrs))(*ptrs)
    build.launch(SPHERE, LIBRARY.load().nee_sphere, device,
                 [addrs, draw_ptr, draw_stride, lights.data_ptr(),
                  lights.shape[0], out.data_ptr(), out.stride(0),
                  valid.data_ptr(), r, n_vec,
                  build.sm_count(device.index)])
    return Vec3(*out[:3]), out[3], valid, Vec3(*out[4:])


def nee_combine(radiance: Vec3, valid, occluded, shadow_radiance: Vec3):
    """radiance + where(valid & ~occluded, shadow_radiance, 0), each
    component rounded as the plain path's add: one launch of
    ``csrc/nee.cu`` over the float32 [R] columns of `radiance` and
    `shadow_radiance` and the bool [R] `valid` and `occluded`. Returns the
    new radiance (Vec3)."""
    cols = (*radiance, *shadow_radiance, valid, occluded)
    dtypes = (torch.float32,) * 6 + (torch.bool,) * 2
    ptrs, r, device = lanes.columns("nee_combine", cols, dtypes)
    out = lanes.rows(3, r, device)
    n_vec = lanes.groups(r, [*ptrs[:6], out.data_ptr()], ptrs[6:])
    addrs = (ctypes.c_ulonglong * len(ptrs))(*ptrs)
    build.launch(COMBINE, LIBRARY.load().nee_combine, device,
                 [addrs, out.data_ptr(), out.stride(0), r, n_vec,
                  build.sm_count(device.index)])
    return Vec3(*out)
