"""What a configuration, traffic mix or cell finds by name: its reference
module, its acceleration builds, its geometry kinds and the viewer's
pull of the image. Fixture manifests in a temporary folder; the three
fixture configurations (``fixture_configs``) are scenes of the port's
builders written as files."""
import hashlib
import json
import shutil
import sys
import types

import numpy as np
import pytest
import torch

from portbench import control, manifest, run, scenes, window
from portbench.reference import pathtrace

HERO_CHECK = manifest.HERE / "checks" / "hero.final-1080p.json"
FRAME = (16, 16)
SEED = 2 ** 31 + 77


def _digest(a) -> str:
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return hashlib.sha256(str(a.dtype).encode() + str(a.shape).encode()
                          + np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def _digest_all(named: dict) -> str:
    flat = {}
    for k, v in named.items():
        if isinstance(v, dict):
            flat.update({f"{k}.{kk}": _digest(vv) for kk, vv in v.items()})
        else:
            flat[k] = _digest(v)
    return _digest(np.frombuffer(json.dumps(flat, sort_keys=True).encode(),
                                 np.uint8))


# SHA-256 prefixes of what the harness before configurations found their
# reference, builds and geometry by name gave: scenes.build at 16x16, its
# port arrays, the reference's scene, and the reference's 16x16 buckets
# over 5 passes from SEED at every pixel
PARENT = {
    "hero.final-1080p": ("d1394c07f67f15fc", "b0c9095ab007c587",
                         "7e6cf39676596e4e", "8f150499b5d83cac"),
    "mesh100k.final-4k": ("12bd53d1ee51b7af", "9fe1edb747d6de2e",
                          "55d9a45049a74db1", "b84b8a92265178a2"),
    "mesh100k.preview-1080p": ("12bd53d1ee51b7af", "9fe1edb747d6de2e",
                               "55d9a45049a74db1", "dadefaa6c58f3c6e"),
    "mesh1p3m.final-1080p": ("61019f87649659b7", "0b82dc158131253b",
                             "06ff0cc9c07f9170", "a2ada8ee74a6a31d"),
}


@pytest.mark.parametrize("cell", sorted(PARENT))
def test_the_cells_reference_inputs_are_the_parents(cell):
    mf = manifest.Manifest()
    wl = mf.workload(cell)
    config, traffic = mf.config(wl["config"]), mf.traffic(wl["traffic"])
    inputs = scenes.build(config, *FRAME)
    ref = run.reference(config)
    assert ref is pathtrace
    rsc = ref.make_scene(inputs, torch.device("cpu"))
    tensors = {f: getattr(rsc, f) for f in rsc.__dataclass_fields__
               if isinstance(getattr(rsc, f), torch.Tensor)}
    pol = run.reference_policy(run.port_policy(config, traffic), config)
    b = ref.buckets(rsc, pol, torch.arange(FRAME[0] * FRAME[1]),
                    SEED & run.MASK, 5, FRAME[0])
    assert (_digest_all(inputs), _digest_all(scenes.port_arrays(inputs)),
            _digest(np.frombuffer(json.dumps(
                {k: _digest(v) for k, v in tensors.items()},
                sort_keys=True).encode(), np.uint8)),
            _digest(b)) == PARENT[cell]


# ---------------------------------------------------------------------------
# The reference's policy
# ---------------------------------------------------------------------------
REFUSED = {"brdf": "ggx", "light_sampling": "power", "mis": False,
           "russian_roulette": False, "median": False,
           "accumulation_buckets": 3, "clamp_radiance": True,
           "sky_bug_compat": True, "enable_dof": True, "rng_scramble": True,
           "log_tile": 3}


@pytest.mark.parametrize("knob", sorted(REFUSED))
def test_pathtrace_refuses_each_knob(knob):
    from cpu_raytracing_experiments_tpu_torch.utils.config import (
        RendererPolicy)

    pol = RendererPolicy(**{knob: REFUSED[knob]})
    with pytest.raises(ValueError, match=knob):
        pathtrace.policy(pol)
    with pytest.raises(ValueError, match=knob):
        run.reference_policy(pol)


def test_the_policy_of_the_default_reference():
    from cpu_raytracing_experiments_tpu_torch.utils.config import (
        RendererPolicy)

    pol = RendererPolicy(max_bounces=4, samples_per_pixel=4,
                         stratify_camera=True)
    assert run.reference_policy(pol) == pathtrace.Policy(4, 4, True)
    assert run.reference_policy(pol, {"reference": "pathtrace"}) == \
        run.reference_policy(pol)


# ---------------------------------------------------------------------------
# Fixture manifests
# ---------------------------------------------------------------------------
def _bvh_test_spheres(num_spheres=255, seed=0x04D15A07):
    """``builders.bvh_test_scene``'s draws, as configuration entries."""
    rng = np.random.Generator(np.random.MT19937(seed))
    out = []
    for _ in range(num_spheres):
        r = rng.uniform(0.3, 20.0)
        center = [rng.uniform(-100, 100), rng.uniform(0, 100),
                  rng.uniform(-100, 100)]
        out.append({"center": center, "radius": r,
                    "material": int(rng.integers(0, 5))})
    return out


def _cornell_quads():
    white, red, green, light = 0, 1, 2, 3
    l0, l1, y = 0.35, 0.65, 0.999
    quads = [
        ([0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1], white),
        ([0, 1, 0], [0, 1, 1], [1, 1, 1], [1, 1, 0], white),
        ([0, 0, 0], [0, 1, 0], [1, 1, 0], [1, 0, 0], white),
        ([0, 0, 0], [0, 0, 1], [0, 1, 1], [0, 1, 0], red),
        ([1, 0, 0], [1, 1, 0], [1, 1, 1], [1, 0, 1], green),
        ([l0, y, l0], [l1, y, l0], [l1, y, l1], [l0, y, l1], light),
    ]
    return [dict(zip(("v0", "v1", "v2", "v3", "material"), q))
            for q in quads]


def fixture_configs() -> dict:
    """Three configurations written as files, each equal to a scene of the
    port's builders: the Cornell box (quads, an emissive quad, two spheres)
    under 'brute', ``bvh_test_scene``'s 255 spheres under 'bvh' and
    ``mesh_scene(subdivisions=2)``'s icosphere under 'grid'."""
    mesh_materials = [
        {"albedo": [0.6, 0.6, 0.6], "roughness": 1.0},
        {"emission": [400.0, 380.0, 320.0], "albedo": [1, 1, 1]},
        {"albedo": [0.75, 0.71, 0.68], "roughness": 0.9}]
    base = {"source": "builders", "reduced": [], "assumed": []}
    return {
        "cornell": dict(base, name="cornell", policy={"accel": "brute"},
                        materials=[
                            {"albedo": [0.73, 0.73, 0.73], "roughness": 1.0},
                            {"albedo": [0.65, 0.05, 0.05], "roughness": 1.0},
                            {"albedo": [0.12, 0.45, 0.15], "roughness": 1.0},
                            {"emission": [17.0, 12.0, 4.0],
                             "albedo": [0.78, 0.78, 0.78]},
                            {"albedo": [0.8, 0.8, 0.9], "roughness": 0.3},
                            {"albedo": [0.9, 0.7, 0.4], "roughness": 1.0}],
                        spheres=[
                            {"center": [0.3, 0.18, 0.35], "radius": 0.18,
                             "material": 4},
                            {"center": [0.68, 0.13, 0.6], "radius": 0.13,
                             "material": 5}],
                        meshes=[{"kind": "quads", "rows": _cornell_quads()}],
                        camera={"eye": [0.5, 0.5, 2.2], "forward": [0, 0, -1],
                                "focal_length": 35.0},
                        sky=[0.0, 0.0, 0.0]),
        "field255": dict(base, name="field255", policy={"accel": "bvh"},
                         bvh={"leaf_size": 4},
                         materials=[
                             {"albedo": [0.8, 0.3, 0.3], "roughness": 1.0},
                             {"albedo": [0.3, 0.8, 0.3], "roughness": 1.0},
                             {"albedo": [0.3, 0.3, 0.8], "roughness": 1.0},
                             {"albedo": [0.7, 0.7, 0.7], "roughness": 1.0},
                             {"emission": [40.0, 38.0, 30.0],
                              "albedo": [1, 1, 1], "roughness": 1.0}],
                         spheres=_bvh_test_spheres(), meshes=[],
                         camera={"eye": [0, 60, 300], "forward": [0, 0, -1]},
                         sky=[1.0, 1.0, 1.0]),
        "ico320": dict(base, name="ico320", policy={"accel": "grid"},
                       grid={"res": 8}, materials=mesh_materials,
                       spheres=[{"center": [0.0, -1000.8, 0.0],
                                 "radius": 1000.0, "material": 0},
                                {"center": [3.0, 4.0, 2.0], "radius": 0.5,
                                 "material": 1}],
                       meshes=[{"kind": "displaced_icosphere",
                                "subdivisions": 2, "displacement": 0.15,
                                "seed": 7, "material": 2}],
                       camera={"eye": [0, 0.4, 3.2], "forward": [0, -0.1, -1],
                               "focal_length": 45.0},
                       sky=[0.15, 0.18, 0.25]),
    }


def fixture_manifest(root, configs: dict, traffic: dict = None,
                     width: int = 16, height: int = 16) -> manifest.Manifest:
    """A benchmark under `root` whose cells are `<config>.tiny`: each of
    `configs` under the final-1080p mix at width x height, one pass an
    update (with `traffic`'s keys on top), held to the hero cell's
    limits."""
    bench = root / "portbench"
    for sub in ("configs", "traffic", "checks"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    mix = json.loads((manifest.HERE / "traffic" / "final-1080p.json")
                     .read_text())
    mix.update(name="tiny", width=width, height=height, passes_per_update=1)
    mix.update(traffic or {})
    (bench / "traffic" / "tiny.json").write_text(json.dumps(mix))
    data = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())
    data["configs"], data["workloads"] = [], []
    for name, config in configs.items():
        (bench / "configs" / f"{name}.json").write_text(json.dumps(config))
        shutil.copy(HERO_CHECK,
                    bench / "checks" / f"{name}.tiny.json")
        data["configs"].append({"name": name, "source": config["source"],
                                "file": f"portbench/configs/{name}.json",
                                "reduced": [], "why": "test"})
        data["workloads"].append({"name": f"{name}.tiny", "config": name,
                                  "traffic": "tiny", "chips": 1,
                                  "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    return manifest.Manifest(root, bench)


def _run(mf, cell, updates=5, **kw):
    return run.run_cell(cell, SEED, 1e9, False, device="cpu", frame=FRAME,
                        max_updates=updates, mf=mf, **kw)


# ---------------------------------------------------------------------------
# A reference by name
# ---------------------------------------------------------------------------
def test_run_and_control_use_the_reference_the_configuration_names(
        tmp_path, monkeypatch):
    calls = []

    def spy(fn):
        def wrapped(*a, **kw):
            calls.append(fn.__name__)
            return fn(*a, **kw)
        return wrapped

    mod = types.ModuleType("portbench.reference.spy")
    for name in ("policy", "make_scene", "buckets", "resolve"):
        setattr(mod, name, spy(getattr(pathtrace, name)))
    monkeypatch.setitem(sys.modules, "portbench.reference.spy", mod)
    hero = manifest.Manifest().config("hero")
    mf = fixture_manifest(tmp_path, {"hero": dict(hero, reference="spy")})
    assert _run(mf, "hero.tiny").result["correct"]
    assert calls == ["policy", "make_scene", "buckets", "resolve"]
    calls.clear()
    control.readings("hero.tiny", 5, 2, device="cpu", frame=(8, 8),
                     pixels=16, mf=mf)
    assert calls == ["policy"] + ["make_scene", "buckets", "resolve"] * 2


@pytest.mark.parametrize("name", ["no_such_reference", "../pathtrace"])
def test_a_reference_that_is_not_there_is_refused(name):
    with pytest.raises((ImportError, ValueError)):
        run.reference({"reference": name})


# ---------------------------------------------------------------------------
# Acceleration builds by name
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy,missing", [
    ({"accel": "bvh"}, "bvh"),
    ({"accel": "grid"}, "grid"),
    ({"accel": "pallas"}, "clusters"),
    ({"use_bvh": True}, "bvh"),
    ({"accel": "brute", "primary_accel": "grid"}, "grid"),
    ({"accel": "clustered"}, "morton_clusters"),
    ({"accel": "brute", "primary_accel": "clustered"}, "morton_clusters"),
])
def test_a_backend_without_its_build_is_refused_before_the_window(
        tmp_path, monkeypatch, policy, missing):
    def window_run(*a, **kw):
        raise AssertionError("the window ran")

    monkeypatch.setattr(window, "run", window_run)
    hero = manifest.Manifest().config("hero")
    mf = fixture_manifest(tmp_path, {"hero": dict(hero, policy=policy)})
    with pytest.raises(ValueError, match=missing):
        _run(mf, "hero.tiny")


def test_an_unknown_configuration_key_is_refused(tmp_path):
    mesh = manifest.Manifest().config("mesh100k")
    config = {k: v for k, v in mesh.items() if k != "clusters"}
    config["cluster"] = mesh["clusters"]
    mf = fixture_manifest(tmp_path, {"mesh100k": config})
    with pytest.raises(ValueError, match="cluster"):
        _run(mf, "mesh100k.tiny")


def test_two_builds_of_the_same_tables_are_refused(tmp_path):
    mesh = manifest.Manifest().config("mesh100k")
    mf = fixture_manifest(tmp_path, {"mesh100k": dict(
        mesh, morton_clusters={"num_clusters": 64})})
    with pytest.raises(ValueError, match="morton_clusters"):
        _run(mf, "mesh100k.tiny")


def test_the_configuration_keys_are_the_scenes_runs_and_builds():
    for name in ("hero", "mesh100k", "mesh1p3m"):
        config = manifest.Manifest().config(name)
        assert set(config) <= run.RUN_KEYS | scenes.KEYS | set(run.BUILDS)
    assert not run.RUN_KEYS & scenes.KEYS


def test_morton_clusters_are_what_clustered_walks(tmp_path):
    """'clustered' runs on ``with_clusters``' morton packs and is
    correct."""
    from cpu_raytracing_experiments_tpu_torch.scene import accel

    config = dict(fixture_configs()["ico320"], name="ico320m",
                  policy={"accel": "clustered"},
                  morton_clusters={"num_clusters": 16})
    del config["grid"]
    mf = fixture_manifest(tmp_path, {"ico320m": config})
    policy = run.port_policy(config, mf.traffic("tiny"))
    builds = run.accel_builds(config, policy)
    assert builds == [("with_clusters", {"num_clusters": 16})]
    inputs = scenes.build(config, *FRAME)
    scene = run.port_scene(inputs, builds)
    plain = accel.with_clusters(run.port_scene(inputs, []), num_clusters=16)
    _equal_arrays(scene.to_numpy(), plain.to_numpy())
    assert scene.sphere_clusters is not None
    assert scene.tri_clusters is not None
    assert _run(mf, "ico320m.tiny").result["correct"]


def test_builds_run_in_the_tables_order():
    from cpu_raytracing_experiments_tpu_torch.utils.config import (
        RendererPolicy)

    config = {"name": "x", "clusters": {"cluster_size": 64},
              "grid": {"res": 8}, "bvh": {}}
    assert run.accel_builds(config, RendererPolicy(
        accel="bvh", primary_accel="pallas")) == [
            ("with_bvh", {}), ("with_grid", {"res": 8}),
            ("with_pallas_clusters", {"cluster_size": 64})]
    config = {"name": "x", "morton_clusters": {}, "bvh": {}}
    assert run.accel_builds(config, RendererPolicy(accel="clustered")) == [
        ("with_bvh", {}), ("with_clusters", {})]


# ---------------------------------------------------------------------------
# Geometry kinds by name, and three configurations as files only
# ---------------------------------------------------------------------------
def _port_builder_scene(name):
    from cpu_raytracing_experiments_tpu_torch.scene import accel, builders

    if name == "cornell":
        return builders.cornell_box_scene(*FRAME)
    if name == "field255":
        return accel.with_bvh(builders.bvh_test_scene(*FRAME), leaf_size=4)
    return accel.with_grid(builders.mesh_scene(*FRAME, subdivisions=2),
                           res=8)


def _equal_arrays(mine: dict, theirs: dict):
    keys = {k for k in theirs if not k.startswith("light_alias")}
    assert set(mine) == keys
    for k in keys:
        if isinstance(theirs[k], dict):
            _equal_arrays(mine[k], theirs[k])
            continue
        a, b = np.asarray(mine[k]), np.asarray(theirs[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k


@pytest.mark.parametrize("name,side", [("cornell", 16), ("field255", 8),
                                       ("ico320", 16)])
def test_a_configuration_of_files_only_runs_and_is_correct(tmp_path, name,
                                                           side):
    """Each configuration's arrays equal its builder's scene; its run is
    correct (the field at 8x8: its BVH walks are slow on the CPU)."""
    config = fixture_configs()[name]
    mf = fixture_manifest(tmp_path, {name: config})
    policy = run.port_policy(config, mf.traffic("tiny"))
    inputs = scenes.build(config, *FRAME)
    scene = run.port_scene(inputs, run.accel_builds(config, policy))
    _equal_arrays(scene.to_numpy(), _port_builder_scene(name).to_numpy())
    # the uniform pick: the port's light list and the reference's name the
    # same lights in the same order, also after the BVH's reorder
    rsc = pathtrace.make_scene(inputs, torch.device("cpu"))
    centers = torch.stack([c for c in scene.spheres.center], -1)
    assert torch.equal(centers[scene.lights.long()], rsc.sph_c[rsc.lights])
    if scene.tri_lights is not None:
        v0 = torch.stack([c for c in scene.triangles.v0], -1)
        assert torch.equal(v0[scene.tri_lights.long()],
                           rsc.tri_v0[rsc.tri_lights])
    out = run.run_cell(f"{name}.tiny", SEED, 1e9, False, device="cpu",
                       frame=(side, side), max_updates=5, mf=mf)
    assert out.result["correct"], out.numbers


def test_quads_split_as_the_scene_builder_splits_them():
    rows = [{"v0": [0, 0, 0], "v1": [1, 0, 0], "v2": [1, 1, 0],
             "v3": [0, 1, 0], "material": 3}]
    v0, v1, v2, mat = scenes.MESHES["quads"]({"kind": "quads", "rows": rows})
    assert v0.tolist() == [[0, 0, 0]] * 2
    assert v1.tolist() == [[1, 0, 0], [1, 1, 0]]
    assert v2.tolist() == [[1, 1, 0], [0, 1, 0]]
    assert mat.tolist() == [3, 3] and mat.dtype == np.int32
    tri = scenes.MESHES["triangles"]({"kind": "triangles", "rows": [
        {"v0": [0, 0, 0], "v1": [1, 0, 0], "v2": [0, 1, 0], "material": 2}]})
    assert [t.tolist() for t in tri] == [[[0, 0, 0]], [[1, 0, 0]],
                                         [[0, 1, 0]], [2]]


def test_an_unknown_mesh_kind_is_refused():
    config = dict(manifest.Manifest().config("hero"),
                  meshes=[{"kind": "teapot", "material": 0}])
    with pytest.raises(ValueError, match="teapot"):
        scenes.build(config, *FRAME)


# ---------------------------------------------------------------------------
# The viewer's pull of the image
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("every_s,pulls", [
    (None, 0),  # no key: an update is accumulate and sync, as before
    (0.0, 1 + 3),  # the warm-up's and each of the window's 3 updates'
    (1e9, 1),  # the warm-up's only: none falls due in the window
])
def test_the_image_is_pulled_at_the_mixs_cadence(tmp_path, monkeypatch,
                                                 every_s, pulls):
    from cpu_raytracing_experiments_tpu_torch.render.api import Renderer

    calls = []
    plain = Renderer.render

    def counted(self, tonemap=True):
        img = plain(self, tonemap)
        calls.append((tonemap, type(img)))
        return img

    monkeypatch.setattr(Renderer, "render", counted)
    hero = manifest.Manifest().config("hero")
    mf = fixture_manifest(tmp_path, {"hero": hero},
                          {} if every_s is None
                          else {"resolve_every_s": every_s})
    out = _run(mf, "hero.tiny", updates=3)
    assert out.result["correct"] and out.result["attempted"] == 3
    # each pull is the viewer's: tonemapped, and read back to the host
    assert calls == [(True, np.ndarray)] * pulls
