"""The tensor-core form of the pair test (the JAX package's MXU form,
``mt_mxu``/``mxu_sel`` over ``_pack_mx`` operands) in the port, on the CPU.

* The operands: ``clusters.limbs`` and ``pack_mx`` give the JAX package's
  ``_limbs`` and ``_pack_mx`` bits (its ``geom_mx`` without the gid
  plane), an in-repo stand-in for ``tests/test_pallas.py``'s
  ``test_mx_packing``, which needs the reference scenes.
* The plain planes (``kernel_core.mx_planes``: the limb products summed in
  float64, rounded once) are within ``test_pallas.py:482``'s bound, 1e-6 of
  the sum of |coefficient x input|, of the float64 dot of the f32 values.
* The plain tensor-core frames against the JAX package's MXU frames in
  interpret mode (``COSIG_MXU=force``; the megakernel's
  ``trace_pallas._MXU_ENV = "force"``), rendered by
  ``test_torch_effects.jax_references`` in a child process without FMA:
  rays within 8; flips (pixels more than 1e-3 apart) at most 0.01 % of a
  frame and never fewer than MIN_FLIPS; outside the flips depth 1 max <=
  2e-6 and deeper RMSE < 1e-5. The two sum the same exact products in
  different orders (XLA's float32 dot, the port's float64 sum rounded
  once), so a grazing pair's validity can turn. At 32 x 32, 0.01 % is a
  tenth of a pixel, and demo_cornell at depth 3 parts on two pixels: a
  ray that grazes a box edge after two reflections (a hit in JAX's MXU
  form, a miss in the port's), and a pixel on the glass box's back face,
  which is coplanar with the back wall (ROADMAP's standing note), where
  the exact forms of the two packages part too.
* ``"closest"`` against ``"full"``, the refusals (unknown modes,
  ``"closest"`` on the megakernel, the debug view) and ``graph_key``.

The kernels run on a card: the ``gpu`` test below and chip_smoke.py
phase 11."""

import os

import numpy as np
import pytest
import torch

import chip_smoke
import cosig_tpu_torch
from cosig_tpu_torch.accel import clusters as tcl
from cosig_tpu_torch.kernels import binding
from cosig_tpu_torch.ops import frame_graph
from cosig_tpu_torch.ops import kernel_core as tkc
from cosig_tpu_torch.ops import trace_megakernel as ttm
from cosig_tpu_torch.ops import trace_wavefront as ttw
from test_torch_effects import jax_references

FLIP_ABS = 1e-3
FLIP_SHARE = 1e-4
MIN_FLIPS = 2


def _jax_clusters(name):
    import cosig_tpu
    from cosig_tpu.accel import clusters as jcl
    from cosig_tpu.models import soa as jsoa
    from cosig_tpu.scene.generate import CONFIGS

    if name == "tiny":
        from __graft_entry__ import _tiny_scene

        scene = _tiny_scene()
    elif name == "demo_cornell":
        scene = cosig_tpu.load_scene("scenes/demo_cornell.txt")
    else:
        scene = CONFIGS[name]()[0]
    return jcl, jcl.build_clusters(jsoa.compile_scene(scene))


@pytest.mark.parametrize("name", ["tiny", "demo_cornell", "glass_sphere"])
def test_pack_mx_and_limbs_match_jax(name):
    """pack_mx and limbs equal _pack_mx and _limbs bit for bit, and the
    port's own cluster build packs the same geom_mx."""
    jcl, jcs = _jax_clusters(name)
    geom = np.asarray(jcs.geom)
    k = geom.shape[1]
    ref_mx, _ = jcl._pack_mx(geom)
    mx = tcl.pack_mx(geom)
    assert mx.dtype == torch.bfloat16 and tuple(mx.shape) == (geom.shape[0], 5 * k, 64)
    np.testing.assert_array_equal(mx.view(torch.int16).numpy(),
                                  np.asarray(ref_mx).view(np.int16)[:, :5 * k])
    for ours, theirs in zip(tcl.limbs(geom), jcl._limbs(geom)):
        np.testing.assert_array_equal(ours.numpy().view(np.int32), theirs.view(np.int32))
    port = chip_smoke.scene_setup(name, dict(resolution_override=(8, 8)), "cpu")["cset"]
    assert torch.equal(port.geom_mx.view(torch.int16), mx.view(torch.int16))
    # Carried across from the JAX set (its 6K rows: the gid plane is dropped).
    carried = tcl.cluster_set_from_arrays(geom, np.asarray(jcs.aabb_t), np.asarray(jcs.sb_aabb_t),
                                          np.asarray(jcs.mats), geom_mx=np.asarray(jcs.geom_mx))
    assert torch.equal(carried.geom_mx.view(torch.int16), mx.view(torch.int16))


def test_limbs_reconstruct_and_planes_within_bound():
    """Every limb is a bf16 value and the three sum to the f32 value
    exactly (huge, tiny and negative values too; not below 2^-126 x 2^16,
    where a subnormal bf16 limb keeps fewer bits than the residual has);
    the plain planes are within 1e-6 x sum |coef x input| of the float64
    dot."""
    rng = np.random.default_rng(7)
    a = np.concatenate([rng.normal(size=4000) * 10.0 ** rng.integers(-30, 30, 4000),
                        [0.0, -0.0, 2.0 ** -110, -(2.0 ** -109) * 1.75, 3.0e38, -1.7e38, 1.0,
                         1.0 + 2 ** -23]])
    a = a.astype(np.float32)
    ls = tcl.limbs(a)
    for lim in ls:
        assert not (lim.numpy().view(np.uint32) & 0xFFFF).any()
    total = sum(lim.double() for lim in ls)
    np.testing.assert_array_equal(total.numpy(), a.astype(np.float64))

    s = chip_smoke.scene_setup("large_mesh", dict(resolution_override=(8, 8)), "cpu")
    cset = s["cset"]
    n = 257
    o = torch.from_numpy((rng.normal(size=(3, n)) * 4.0).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32))
    d = d / d.norm(dim=0)
    ox, oy, oz = o
    dx, dy, dz = d
    w = (oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx)
    rl = tkc.ray_limbs(ox, oy, oz, dx, dy, dz, *w)
    x = torch.stack([ox, oy, oz, dx, dy, dz, *w, torch.ones_like(ox)]).double()
    for c in (0, cset.num_clusters // 2, cset.num_clusters - 1):
        g = cset.geom[c].double()
        planes = tkc.mx_planes(cset.geom_mx[c], rl)
        coefs = [(g[:, tcl.VA:tcl.VA + 6], range(3, 9)), (g[:, tcl.VB:tcl.VB + 6], range(3, 9)),
                 (g[:, tcl.VC:tcl.VC + 6], range(3, 9)), (g[:, tcl.GN:tcl.GN + 3], range(3, 6)),
                 (torch.cat([-g[:, tcl.GN:tcl.GN + 3], g[:, tcl.NDA:tcl.NDA + 1]], 1),
                  (0, 1, 2, 9))]
        for p, (cf, inputs) in enumerate(coefs):
            want = sum(x[i][:, None] * cf[None, :, j] for j, i in enumerate(inputs))
            mag = sum((x[i][:, None] * cf[None, :, j]).abs() for j, i in enumerate(inputs))
            assert bool(((planes[p].double() - want).abs() <= 1e-6 * mag).all()), p


def test_mx_any_hit_counts_whole_row_tiles():
    """The any hit in the tensor-core form counts a shadow ray's pair tests
    up to the end of the 8-row tile of its first occluder (as the kernel
    tests them), never fewer than the exact form; occlusion is the same."""
    s = chip_smoke.scene_setup("large_mesh", dict(resolution_override=(24, 16), max_depth=1),
                               "cpu")
    cset = s["cset"]
    rng = np.random.default_rng(3)
    n = 600
    o = torch.from_numpy((rng.normal(size=(3, n)) * 3.0 + [[0.0], [2.0], [0.0]]).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32))
    d = d / d.norm(dim=0)
    act = torch.ones(n, dtype=torch.bool)
    max_t = torch.full((n,), 50.0)
    counts, occ = {}, {}
    for mx in (False, True):
        tkc.reset_work()
        occ[mx] = tkc.traverse(cset, *o, *d, act, max_t=max_t, any_hit=True, mx=mx)[0]
        counts[mx] = tkc.WORK["pair_tests"]
    assert torch.equal(occ[True], occ[False]) and bool(occ[True].any())
    assert counts[True] >= counts[False]


# ---- the geometry operand's shared-memory tile (csrc/mx_layout.h) ----

_LAYOUT_SRC = """
#include "mx_layout.h"
extern "C" {
int b_offset(int p, int c, int r, int q) { return cosig::mx_b_offset(p, c, r, q); }
int core_limb(int c) { return cosig::mx_core_limb(c); }
int step_core(int s, int h) { return cosig::mx_step_core(s, h); }
unsigned long long desc(unsigned tile, int p0, int s) { return cosig::mx_desc(tile, p0, s); }
int constant(int i) {
  const int v[] = {cosig::MX_TILE_ROWS, cosig::MX_PLANES, cosig::MX_SLOTS, cosig::MX_CORES,
                   cosig::MX_CORE_BYTES, cosig::MX_GROUP_BYTES, cosig::MX_B_BYTES,
                   cosig::MX_B_ALIGN};
  return v[i];
}
}
"""
_LAYOUT_NAMES = ("TILE_ROWS", "PLANES", "SLOTS", "CORES", "CORE_BYTES", "GROUP_BYTES",
                 "B_BYTES", "B_ALIGN")
# The operands of the kernel's k-steps: (first plane, columns).
_OPERANDS = {"X": (0, 32), "Z": (4, 8)}


@pytest.fixture(scope="module")
def mx_layout(tmp_path_factory):
    """csrc/mx_layout.h built by g++ into a small library (as
    cosig_tpu_torch/native builds its sources) -> (ctypes library, its
    constants by name)."""
    import ctypes
    import shutil
    import subprocess

    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build csrc/mx_layout.h")
    d = tmp_path_factory.mktemp("mx_layout")
    (d / "layout.cc").write_text(_LAYOUT_SRC)
    csrc = os.path.join(os.path.dirname(cosig_tpu_torch.__file__), "csrc")
    subprocess.run([cxx, "-O2", "-std=c++17", "-fPIC", "-shared", "-I", csrc, "-o",
                    str(d / "layout.so"), str(d / "layout.cc")], check=True)
    lib = ctypes.CDLL(str(d / "layout.so"))
    lib.desc.restype = ctypes.c_ulonglong
    lib.desc.argtypes = [ctypes.c_uint, ctypes.c_int, ctypes.c_int]
    return lib, {n: lib.constant(i) for i, n in enumerate(_LAYOUT_NAMES)}


def _canonical(desc: int, n_cols: int) -> np.ndarray:
    """The PTX ISA's canonical K-major layout without swizzle (wgmma's
    shared-memory matrix descriptor, layout type 0) read from a
    descriptor's fields: the byte address of element (column n, k) of a
    k16 bf16 operand, [n_cols, 16]. Core matrices are 8 columns x 16
    bytes, column r of a core at 16 r; the two cores along K are LBO apart,
    the next 8 columns SBO."""
    start = (desc & 0x3FFF) << 4
    lbo = ((desc >> 16) & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    n = np.arange(n_cols)[:, None]
    k = np.arange(16)[None, :]
    return start + (n % 8) * 16 + (n // 8) * sbo + (k % 8) * 2 + (k // 8) * lbo


def test_mx_b_tile_layout_is_canonical(mx_layout):
    """The tile writer's offsets (mx_b_offset: plane, core, row, slot) fill
    the tile once, 16-byte aligned core rows; each k-step's descriptor
    (mx_desc, no swizzle, base offset 0) reads, through the canonical
    K-major layout, every (column, k) of its operand at a distinct byte of
    the tile, at the core-matrix offsets, and finds there the limb that
    MX_COMBOS puts in that column: geometry limb j of input slot k % 8 of
    plane 8 p0 + column's row."""
    lib, c = mx_layout
    assert (c["TILE_ROWS"], c["PLANES"], c["SLOTS"]) == (tkc.MX_ROWS, tcl.MX_PLANES, 8)
    assert c["CORE_BYTES"] == 8 * 16 and c["B_BYTES"] == c["PLANES"] * c["GROUP_BYTES"]
    writer = {}
    for p in range(c["PLANES"]):
        for core in range(c["CORES"]):
            for r in range(c["TILE_ROWS"]):
                for q in range(c["SLOTS"]):
                    off = lib.b_offset(p, core, r, q)
                    assert off % 2 == 0 and (off - 2 * q) % 16 == 0
                    writer[off] = (p, lib.core_limb(core), r, q)
    assert sorted(writer) == list(range(0, c["B_BYTES"], 2))
    tile = 3 * c["B_ALIGN"]  # a shared-memory address of a tile
    for s in range(3):
        for name, (p0, n_cols) in _OPERANDS.items():
            dsc = lib.desc(tile, p0, s)
            assert dsc >> 62 == 0 and (dsc >> 49) & 7 == 0, (name, s)  # no swizzle
            addr = _canonical(dsc, n_cols)
            assert len(np.unique(addr)) == addr.size, (name, s)
            assert addr.min() >= tile and addr.max() < tile + c["B_BYTES"], (name, s)
            for n in range(n_cols):
                for k in range(16):
                    p, j, r, q = writer[int(addr[n, k]) - tile]
                    want = (p0 + n // 8, tcl.MX_COMBOS[2 * s + k // 8][0], n % 8, k % 8)
                    assert (p, j, r, q) == want, (name, s, n, k)


def test_mx_b_tile_products_give_the_planes(mx_layout):
    """The kernel's data path in numpy: a cluster's rows split into tiles as
    mx_split writes them (the limbs of clusters.limbs, pack_mx's bits),
    each k-step's B read through its descriptor's canonical layout, A the
    rays' limbs in MX_COMBOS order, the three k-steps' products summed in
    float64: the plain planes (kernel_core.mx_planes, float64) within 1e-12
    of sum |coef x input| (the same exact products in another order)."""
    lib, c = mx_layout
    s = chip_smoke.scene_setup("glass_sphere", dict(resolution_override=(8, 8)), "cpu")
    cset = s["cset"]
    k = cset.k
    rng = np.random.default_rng(5)
    n = 64
    o = torch.from_numpy((rng.normal(size=(3, n)) * 4.0).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32))
    d = d / d.norm(dim=0)
    ox, oy, oz = o
    dx, dy, dz = d
    w = (oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx)
    rl = tkc.ray_limbs(ox, oy, oz, dx, dy, dz, *w).double().numpy()  # [10, 3, n]
    # Input slots of the two operands: X = d, w; Z = o, 1 (ray_limbs' order).
    slots = {"X": (3, 4, 5, 6, 7, 8), "Z": (0, 1, 2, 9)}
    tile = c["B_ALIGN"]
    for cl in (0, cset.num_clusters - 1):
        g = cset.geom[cl].double().numpy()
        coef = [g[:, tcl.VA:tcl.VA + 6], g[:, tcl.VB:tcl.VB + 6], g[:, tcl.VC:tcl.VC + 6],
                g[:, tcl.GN:tcl.GN + 3], np.concatenate([-g[:, tcl.GN:tcl.GN + 3],
                                                         g[:, tcl.NDA:tcl.NDA + 1]], 1)]
        lim = [np.stack([x.numpy() for x in tcl.limbs(torch.from_numpy(cf.astype(np.float32)))])
               for cf in coef]  # [3, k, slots] per plane
        exact = tkc.mx_planes(cset.geom_mx[cl], torch.from_numpy(rl).float(), f64=True)
        for nt in range(k // c["TILE_ROWS"]):
            buf = np.zeros(c["B_BYTES"] // 2)  # the tile's bf16 values, by 2-byte slot
            for p in range(c["PLANES"]):
                for core in range(c["CORES"]):
                    for r in range(c["TILE_ROWS"]):
                        for q in range(lim[p].shape[2]):
                            buf[lib.b_offset(p, core, r, q) // 2] = \
                                lim[p][lib.core_limb(core), 8 * nt + r, q]
            for name, (p0, n_cols) in _OPERANDS.items():
                acc = np.zeros((n, n_cols))
                for st in range(3):
                    b = buf[(_canonical(lib.desc(tile, p0, st), n_cols) - tile) // 2]  # [N, 16]
                    a = np.zeros((n, 16))
                    for k16 in range(16):
                        if k16 % 8 < len(slots[name]):
                            a[:, k16] = rl[slots[name][k16 % 8],
                                           tcl.MX_COMBOS[2 * st + k16 // 8][1]]
                    acc += a @ b.T
                for col in range(n_cols):
                    p, r = p0 + col // 8, 8 * nt + col % 8
                    want = exact[p][:, r].numpy()
                    inputs = [rl[i].sum(0) for i in slots[name]]
                    mag = sum(np.abs(x * cf) for x, cf in zip(inputs, coef[p][r]))
                    assert np.all(np.abs(acc[:, col] - want) <= 1e-12 * mag + 1e-300), \
                        (cl, nt, name, col)


# (template, its flags, the launch counter's name): every build of a ray kernel.
_BUILDS = [("primary_kernel", (0, 0, 0), "primary"), ("primary_kernel", (0, 0, 1), "primary_mx"),
           ("primary_kernel", (0, 1, 0), "primary_fission"),
           ("primary_kernel", (0, 1, 1), "primary_fission_mx"),
           ("primary_kernel", (1, 0, 0), "primary_shadow"),
           ("primary_kernel", (1, 0, 1), "primary_shadow_mx"),
           ("bounce_kernel", (0, 0), "bounce"), ("bounce_kernel", (0, 1), "bounce_mx"),
           ("bounce_kernel", (1, 0), "bounce_shadow"), ("bounce_kernel", (1, 1), "bounce_shadow_mx"),
           ("trace_kernel", (0,), "trace"), ("trace_kernel", (1,), "trace_mx"),
           ("shade_kernel", (1, 0), "shade"), ("shade_kernel", (1, 1), "shade_mx"),
           ("shade_kernel", (0, 0), "shade_all"), ("shade_kernel", (0, 1), "shade_all_mx"),
           ("megakernel", (0,), "megakernel"), ("megakernel", (1,), "megakernel_mx"),
           ("debug_kernel", (), "debug")]


@pytest.mark.parametrize("sb", [0, 1])
def test_build_labels_name_every_build(sb):
    """kernels.sass.build_label reads each ray kernel build's template flags
    from its mangled name (the first, SB, the superblock cull) and names
    it as its launch counter does, so chip_smoke.check_tensor_ops finds
    every tensor-core build (and ptxas_resources every build)."""
    from cosig_tpu_torch.kernels import sass

    for base, flags, label in _BUILDS:
        args = "".join(f"Lb{f}E" for f in (sb, *flags))
        mangled = f"_ZN5cosig{len(base)}{base}I{args}EEvNS_5FrameEPKf"
        assert sass.build_label(mangled) == (label, bool(sb)), mangled
        assert label in binding.LAUNCHES or label == "shade_all"
    assert sass.build_label("_ZN5cosig14compact_kernelEPKfiPiS2_") == ("compact", False)
    assert sass.build_label("_ZN5cosig9some_funcEv") is None
    names = {label for _, _, label in _BUILDS}
    assert set(chip_smoke.MX_BUILDS) == {n for n in names if n.endswith("_mx")}


# ---- against the JAX package's MXU form (interpret mode, no FMA) ----

MX_CASES = {
    # key: (scene, settings, path)
    "wf_tiny_d1": ("tiny", dict(resolution_override=(32, 32), max_depth=1), "wavefront"),
    "wf_tiny_d3": ("tiny", dict(resolution_override=(32, 32), max_depth=3), "wavefront"),
    "wf_cornell_d1": ("demo_cornell", dict(resolution_override=(32, 32), max_depth=1),
                      "wavefront"),
    "wf_cornell_d3": ("demo_cornell", dict(resolution_override=(32, 32), max_depth=3),
                      "wavefront"),
    "mk_tiny_d3": ("tiny", dict(resolution_override=(32, 32), max_depth=3), "megakernel"),
    "mk_cornell_d3": ("demo_cornell", dict(resolution_override=(32, 32), max_depth=3),
                      "megakernel"),
}


@pytest.fixture(scope="module")
def mx_refs(tmp_path_factory):
    jobs = [dict(key=key, scene=name, settings=kw, path=path, mxu=True)
            for key, (name, kw, path) in MX_CASES.items()]
    return jax_references(jobs, tmp_path_factory.mktemp("mxu"))


def hold_mx(img, rays, ref, ref_rays, max_depth):
    """A plain tensor-core frame against the JAX package's MXU frame."""
    img = img.numpy().astype(np.float64)
    assert img.shape == ref.shape
    assert abs(rays - ref_rays) <= 8
    d = np.abs(img - ref).max(axis=2)
    flips = d > FLIP_ABS
    print("flips at", np.argwhere(flips).tolist(), "by", d[flips].tolist())
    assert flips.sum() <= max(MIN_FLIPS, FLIP_SHARE * d.size), flips.sum()
    if max_depth == 1:
        assert d[~flips].max() <= 2e-6, d[~flips].max()
    else:
        assert np.sqrt(((img - ref)[~flips] ** 2).mean()) < 1e-5


@pytest.mark.parametrize("key", list(MX_CASES))
def test_mx_frames_match_jax_mxu(mx_refs, key):
    name, kw, path = MX_CASES[key]
    s = chip_smoke.scene_setup(name, kw, "cpu")
    render = ttw.render_wavefront if path == "wavefront" else ttm.render_clusters
    img, rays = render(s["cset"], s["uni"], s["lights"], s["cfg"], mxu="full")
    hold_mx(img, rays, *mx_refs[key], s["cfg"].max_depth)


def test_closest_against_full():
    """"closest" runs the closest hits in the tensor-core form and the
    shadow rays in the exact one: without diffuse light (no shadow rays) it
    is "full" bit for bit; with it, within the slice tolerances of "full"
    (occlusion differs only on grazing pairs), and both differ from the
    exact frame."""
    kw = dict(resolution_override=(32, 32), max_depth=3)
    s = chip_smoke.scene_setup("demo_cornell", dict(kw, enable_diffuse=False), "cpu")
    a = (s["cset"], s["uni"], s["lights"], s["cfg"])
    full, rays_f = ttw.render_wavefront(*a, mxu="full")
    closest, rays_c = ttw.render_wavefront(*a, mxu="closest")
    assert torch.equal(full, closest) and rays_f == rays_c
    s = chip_smoke.scene_setup("demo_cornell", kw, "cpu")
    a = (s["cset"], s["uni"], s["lights"], s["cfg"])
    full, rays_f = ttw.render_wavefront(*a, mxu="full")
    closest, rays_c = ttw.render_wavefront(*a, mxu="closest")
    exact, _ = ttw.render_wavefront(*a)
    assert abs(rays_f - rays_c) <= 8
    assert float((full - closest).pow(2).mean().sqrt()) < 1e-5
    assert not torch.equal(full, exact)


def test_refusals_and_graph_key():
    s = chip_smoke.scene_setup("demo_cornell", dict(resolution_override=(16, 12), max_depth=2),
                               "cpu")
    cset, cfg = s["cset"], s["cfg"]
    a = (cset, s["uni"], s["lights"], cfg)
    shadow = chip_smoke.form_sets(s, dict(shadow=64), "cpu")["shadow"]
    # The fission form and a separate shadow set take the tensor-core form
    # too (tests/test_torch_mxu_forms.py holds their frames): these run.
    for kw in (dict(fission=True), dict(cset_shadow=shadow)):
        for call in (lambda: ttw.render_wavefront(*a, mxu="full", **kw),
                     lambda: ttw.trace_state(*a, mxu="closest", **kw),
                     lambda: ttw.render_chain(*a, 1, mxu="full", **kw),
                     lambda: frame_graph.render_chain("wavefront", *a, 1, mxu="full", **kw)):
            res = call()
            img = res[0] if isinstance(res, tuple) else ttw.finalize(res, cfg, cfg.height)[0]
            assert img.shape == (cfg.height, cfg.width, 3) and bool(torch.isfinite(img).all())
    for call in (lambda: ttm.render_clusters(*a, mxu="closest"),
                 lambda: ttm.render_chain(*a, 1, mxu="closest"),
                 lambda: frame_graph.render_chain("megakernel", *a, 1, mxu="closest"),
                 lambda: cosig_tpu_torch.Renderer(device="cpu", backend="megakernel",
                                                  mxu="closest")):
        with pytest.raises(ValueError, match="megakernel"):
            call()
    with pytest.raises(ValueError, match="debug"):
        frame_graph.render_chain("debug", *a, 1, mxu="full")
    for call in (lambda: ttw.render_wavefront(*a, mxu="on"),
                 lambda: cosig_tpu_torch.Renderer(device="cpu", mxu="yes")):
        with pytest.raises(ValueError, match="mxu"):
            call()
    # A set without geom_mx is refused where the form would run ...
    bare = tcl.cluster_set_from_arrays(cset.geom.numpy(), cset.aabb_t.numpy(),
                                       cset.sb_aabb_t.numpy(), cset.mats.numpy())
    assert bare.geom_mx is None
    for call in (lambda: ttw.render_wavefront(bare, *a[1:], mxu="full"),
                 lambda: ttm.render_clusters(bare, *a[1:], mxu="full")):
        with pytest.raises(ValueError, match="geom_mx"):
            call()
    # ... but a set past 6 MiB keeps the exact test, as JAX's streamed stages do.
    big = tcl.cluster_set_from_arrays(np.zeros((1400, 32, tcl.GEOM_COMPS), np.float32),
                                      np.full((8, 1536), np.nan, np.float32),
                                      np.full((8, 128), np.nan, np.float32), np.zeros((1, 8)))
    assert big.streamed and tkc.mxu_mode(big, "full") == "off"
    assert tkc.mxu_mode(cset, "closest") == "closest" and not cset.streamed
    # graph_key includes the form: the pair test's, then the wavefront's.
    scene, settings = chip_smoke.load("demo_cornell")
    keys = {m: cosig_tpu_torch.Renderer(device="cpu", mxu=m).graph_key(scene, settings)
            for m in tkc.MXU_MODES}
    assert len(set(keys.values())) == 3 and keys["full"][4:] == ("full", "fused")
    assert keys["off"][4:] == ("off", "fission") and keys["closest"][4:] == ("closest", "fused")
    # The debug view and the oracle path have only the exact test: refused.
    debug = settings.replace(debug_mode=1)
    assert cosig_tpu_torch.Renderer(device="cpu").graph_key(scene, debug)[4:] == ("off", "fused")
    with pytest.raises(ValueError, match="debug"):
        cosig_tpu_torch.Renderer(device="cpu", mxu="full").graph_key(scene, debug)
    with pytest.raises(ValueError, match="debug"):
        cosig_tpu_torch.Renderer(device="cpu", mxu="full").render(scene, debug)
    for backend in ("xla", "xla-brute", "auto"):
        with pytest.raises(ValueError, match="mxu"):
            cosig_tpu_torch.Renderer(device="cpu", backend=backend, mxu="closest")


def test_renderer_mxu_on_cpu():
    """Renderer(mxu=) on the CPU runs the plain tensor-core stages: the
    wavefront's frame is render_wavefront(mxu=)'s, the megakernel's its
    own render_clusters(mxu=)'s."""
    scene, settings = chip_smoke.load("tiny")
    settings = settings.replace(resolution_override=(24, 16), max_depth=2)
    s = chip_smoke.scene_setup("tiny", dict(resolution_override=(24, 16), max_depth=2), "cpu")
    a = (s["cset"], s["uni"], s["lights"], s["cfg"])
    for backend, render in (("wavefront", ttw.render_wavefront),
                            ("megakernel", ttm.render_clusters)):
        img = cosig_tpu_torch.Renderer(device="cpu", backend=backend,
                                       mxu="full").render_to_device(scene, settings)
        assert torch.equal(img, render(*a, mxu="full")[0])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


# demo_cornell at 48 x 32, d3, AA 1 on the card: the pixels (x, y) where the
# megakernel's frame parts from its plain version's by more than FLIP_ABS
# (the wavefront kernels' frame parts on the same three). Each turns on
# one pair: triangles 0 and 9 of the soup, the back wall and the glass
# box's back face, both in the plane z = -6, whose t are equal or an ulp
# apart, so the kernel's and the plain version's sums can order them
# either way. (27, 15) turns at bounce 1 on equal inputs (ray 747, the
# stage-by-stage check's one flip); (27, 16) at bounce 1 and (26, 17) at
# bounce 2 after an earlier stage moved them within the stage gates
# (whole frames are independent chains). The test checks each.
CARD_FLIP_PIXELS = {(27, 15), (27, 16), (26, 17)}


@pytest.mark.gpu
def test_mx_kernels_on_card(card):
    """On a card the tensor-core builds launch (primary_mx, bounce_mx,
    megakernel_mx, in both modes), each wavefront stage holds its plain
    version on the same input state at the gates of the JAX comparison
    above (flips at most max(MIN_FLIPS, 0.01 %)), the megakernel's frame
    equals the wavefront kernels' bit for bit, and it holds its plain
    version's frame outside CARD_FLIP_PIXELS (RMSE < 1e-5, rays within 8).
    demo_cornell's glass-box back face is coplanar with the back wall, so
    two valid pairs there can swap their t order between the two summation
    orders (chip_smoke ``explain_flip`` names the pairs)."""
    from cosig_tpu_torch.kernels import wavefront as kw

    s = chip_smoke.scene_setup("demo_cornell", dict(resolution_override=(48, 32), max_depth=3),
                               card)
    cset, cfg = s["cset"], s["cfg"]
    uni, lights, mats, prims, n_sph, n_box = ttw.frame_inputs(cset, s["uni"], s["lights"], 0,
                                                               None, None, (0, 0))
    pk = (prims, n_sph, n_box)
    fb = binding.frame_buffer(card, uni, mats, lights)

    def held(a, b):
        """A stage's state [16, N] against its plain version's: rays whose
        rows 0-12 part by more than FLIP_ABS are flips; the rest within
        the RMSE gate, the ray counts within 8."""
        d = (a[:13] - b[:13]).abs().cpu().double()
        flips = (d > FLIP_ABS).any(dim=0)
        print("flipped rays", torch.nonzero(flips).squeeze(1).tolist())
        assert int(flips.sum()) <= max(MIN_FLIPS, FLIP_SHARE * d.shape[1])
        assert float(d[:, ~flips].pow(2).mean().sqrt()) < 1e-5
        assert abs(float(a[tkc.ROW_COUNT].sum()) - float(b[tkc.ROW_COUNT].sum())) <= 8

    for mode in ("full", "closest"):
        binding.reset_counts()
        st = kw.primary(cset, fb, cfg, cfg.height, *pk, mxu=mode)
        held(st, ttw.primary_stage(cset, uni, mats, lights, cfg, cfg.height, *pk, mxu=mode))
        for d in range(1, cfg.max_depth):
            idx, n_live = kw.compact(st)
            ref = st.clone()
            kw.bounce(st, idx, n_live, cset, fb, cfg, d, *pk, mxu=mode)
            ttw.bounce_listed_stage(ref, idx, n_live, cset, uni, mats, lights, cfg, d, *pk,
                                    mxu=mode)
            held(st, ref)
        assert binding.LAUNCHES["primary_mx"] == 1 and binding.LAUNCHES["bounce_mx"] == 2
        assert binding.LAUNCHES["primary"] == binding.LAUNCHES["bounce"] == 0
    # The megakernel runs the same per-ray device code: at AA 1 its frame is
    # the wavefront kernels' bit for bit.
    a = (cset, s["uni"], s["lights"], cfg)
    img_w, rays_w = ttw.render_wavefront(*a, mxu="full")
    binding.reset_counts()
    img, rays = ttm.render_clusters(*a, mxu="full")
    assert binding.LAUNCHES["megakernel_mx"] == 1 and binding.LAUNCHES["megakernel"] == 0
    assert torch.equal(img, img_w) and rays == rays_w
    # Against its plain version: whole frames, so a turned pair's pixel
    # parts (CARD_FLIP_PIXELS); every other pixel holds the slice gate.
    img_p, rays_p = ttm.render_clusters(*a, plain=True, mxu="full")
    d = (img - img_p).abs().reshape(-1, 3).cpu().double()
    flips = (d > FLIP_ABS).any(dim=1)
    pixels = {(i % cfg.width, i // cfg.width) for i in torch.nonzero(flips).squeeze(1).tolist()}
    print("megakernel pixels apart from the plain frame", sorted(pixels))
    assert pixels <= CARD_FLIP_PIXELS
    assert float(d[~flips].pow(2).mean().sqrt()) < 1e-5
    assert abs(rays - rays_p) <= 8
    # Each of those pixels turns on the coplanar pair. Along independent
    # chains (the kernels' and the plain version's), at the first stage
    # where a ray parts, the closest hit's winners under the kernel's planes
    # and under the plain ones (chip_smoke.explain_flip, on the plain
    # chain's input) are triangles 0 and 9, which lie in one plane.
    sk = kw.primary(cset, fb, cfg, cfg.height, *pk, mxu="full")
    sp = ttw.primary_stage(cset, uni, mats, lights, cfg, cfg.height, *pk, mxu="full")
    assert not bool(((sk[:13] - sp[:13]).abs() > FLIP_ABS).any())
    turned = {}
    for depth in range(1, cfg.max_depth):
        o, dirs = sp[0:3].clone(), sp[3:6].clone()
        idx, n_live = kw.compact(sk)
        kw.bounce(sk, idx, n_live, cset, fb, cfg, depth, *pk, mxu="full")
        idx, n_live = ttw.compact_plain(sp)
        ttw.bounce_listed_stage(sp, idx, n_live, cset, uni, mats, lights, cfg, depth, *pk,
                                mxu="full")
        parted = ((sk[:13] - sp[:13]).abs() > FLIP_ABS).any(dim=0)
        for r in torch.nonzero(parted).squeeze(1).tolist():
            if r not in turned:
                res = chip_smoke.explain_flip(cset, o[:, r], dirs[:, r], f"bounce {depth} ray {r}")
                turned[r] = {res["winners"]["kernel"][1], res["winners"]["plain"][1]}
    print("rays parted along the chains and their winners' gids", turned)
    assert {(r % cfg.width, r // cfg.width) for r in turned} == pixels
    assert all(gids == {0.0, 9.0} for gids in turned.values())
    geom = cset.geom.reshape(-1, tcl.GEOM_COMPS).double()
    planes = []
    for gid in (0.0, 9.0):
        row = geom[geom[:, tcl.GID] == gid][0]
        norm = row[tcl.GN:tcl.GN + 3].norm()
        planes.append((row[tcl.GN:tcl.GN + 3] / norm, row[tcl.NDA] / norm))
    assert torch.allclose(planes[0][0], -planes[1][0]) and torch.isclose(planes[0][1],
                                                                           -planes[1][1])
