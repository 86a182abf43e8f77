"""The kernel library's binding and the kernels' launch counters.

The library (built by :mod:`cosig_tpu_torch.kernels.build`) holds the
seven kernels of ``csrc/`` (primary, compaction, bounce, trace, shade,
megakernel, debug) behind plain C launchers; this module loads it with ctypes,
mirrors ``struct Frame`` (a launch's own parameters, by value) and
``struct FrameData`` (a frame's uniforms, materials and lights, which
the kernels read from device memory through ``Frame::data``), checks the
tensors they read and launches them on the current stream.

A :class:`FrameBuffer` holds one frame's ``FrameData``: packed with
numpy into pinned host memory and copied to its device buffer on the
current stream, ahead of the launches that read it. A CUDA graph of a
frame keeps the buffer's address, so writing the buffer and replaying
renders another camera without a new capture
(:mod:`cosig_tpu_torch.ops.frame_graph`).

``LAUNCHES`` counts kernel launches per kernel (``primary``, ``compact``,
``bounce``, ``trace``, ``shade``, ``megakernel``, ``debug``; the
wavefront's other builds apart: ``primary_fission``, the primary that
stops after its trace, and ``primary_shadow``/``bounce_shadow``, the
builds whose shadow rays walk a separate cluster set; the builds with the
tensor-core pair test ``primary_mx``, ``bounce_mx`` and ``megakernel_mx``,
in full and closest-only mode alike, and in the other forms
``primary_fission_mx``, ``trace_mx``, ``primary_shadow_mx``,
``bounce_shadow_mx``, and in full mode the shade's ``shade_mx`` (on a
list) and ``shade_all_mx`` (over every ray of the primary stage)) and
graph replays (``graph``);
each wrapper of :mod:`cosig_tpu_torch.kernels.wavefront` and
:mod:`cosig_tpu_torch.kernels.megakernel` adds one where it launches its
kernel, a replay adds the kernels its graph holds and one ``graph``, and
plain runs on the CPU count nothing. One ``compact`` is one call of the
compaction kernel, which is one cooperative CUDA launch.
:func:`reset_counts` sets every counter to 0.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from cosig_tpu_torch.accel.clusters import CULL_BLOCK, GEOM_COMPS, MAX_SUPERBLOCKS, ClusterSet
from cosig_tpu_torch.kernels import build as kbuild
from cosig_tpu_torch.models.soa import StaticConfig
from cosig_tpu_torch.ops import camera, trace_wavefront
from cosig_tpu_torch.ops.kernel_core import UNIFORMS_LEN
from cosig_tpu_torch.utils import trace

F32 = np.float32

MAX_MATS = 64  # csrc/bounce.cuh
MAX_LIGHTS = 16
OCTANTS = 8  # csrc/wavefront.cu: the compaction's keys

# Flag bits of csrc/bounce.cuh (StaticConfig toggles).
_FLAGS = (
    ("enable_ambient", 1),
    ("enable_diffuse", 2),
    ("enable_specular", 4),
    ("enable_refraction", 8),
    ("is_orthographic", 16),
    ("enable_soft_shadows", 32),
    ("enable_glossy", 64),
    ("enable_motion_blur", 128),
    ("multi_light", 256),
)
# The tensor-core builds' shadow rays take that form too (full mode).
F_MX_SHADOW = 512

LAUNCHES = {"primary": 0, "compact": 0, "bounce": 0, "trace": 0, "shade": 0,
            "primary_fission": 0, "primary_shadow": 0, "bounce_shadow": 0,
            "primary_mx": 0, "bounce_mx": 0, "megakernel_mx": 0,
            "primary_fission_mx": 0, "trace_mx": 0, "shade_mx": 0, "shade_all_mx": 0,
            "primary_shadow_mx": 0, "bounce_shadow_mx": 0,
            "megakernel": 0, "debug": 0, "graph": 0}


def reset_counts() -> None:
    """Set every launch counter to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# Mirror of ``struct FrameData`` in csrc/bounce.cuh (all fields 4 bytes).
FRAME_DATA = np.dtype([
    ("u", "<f4", (UNIFORMS_LEN,)),
    ("n_mats", "<i4"),
    ("n_lights", "<i4"),
    ("mats", "<f4", (MAX_MATS * 8,)),
    ("lights", "<f4", (MAX_LIGHTS * 8,)),
])


class Frame(ctypes.Structure):
    """Mirror of ``struct Frame`` in csrc/bounce.cuh: a launch's parameters."""

    _fields_ = [
        ("flags", ctypes.c_int),
        ("width", ctypes.c_int),
        ("height", ctypes.c_int),
        ("band", ctypes.c_int),
        ("aa", ctypes.c_int),
        ("grid_w", ctypes.c_int),
        ("grid_h", ctypes.c_int),
        ("aspect", ctypes.c_float),
        ("n_rays", ctypes.c_int),
        ("depth", ctypes.c_int),
        ("is_last", ctypes.c_int),
        ("data", ctypes.c_void_p),
    ]


def config_flags(cfg: StaticConfig) -> int:
    return sum(bit for name, bit in _FLAGS if getattr(cfg, name))


def pack_frame_data(out: np.ndarray, uniforms: np.ndarray, mats: np.ndarray,
                    lights: np.ndarray) -> None:
    """Write one frame's uniforms, materials and lights into ``out``, a
    :data:`FRAME_DATA` record (numpy writes, no per-float Python); the
    unused material and light rows are zeros."""
    mats = np.asarray(mats, F32)
    lights = np.asarray(lights, F32)
    if mats.shape[0] > MAX_MATS or lights.shape[0] > MAX_LIGHTS:
        raise ValueError(
            f"the kernels take at most {MAX_MATS} materials and {MAX_LIGHTS} lights; "
            f"got {mats.shape[0]} and {lights.shape[0]}"
        )
    if np.shape(uniforms) != (UNIFORMS_LEN,):
        raise ValueError(f"uniforms must be [{UNIFORMS_LEN}], got {np.shape(uniforms)}")
    out["u"] = uniforms
    out["n_mats"], out["n_lights"] = mats.shape[0], lights.shape[0]
    out["mats"] = 0.0
    out["mats"][: mats.size] = mats.ravel()
    out["lights"] = 0.0
    out["lights"][: lights.size] = lights.ravel()


class FrameBuffer:
    """One frame's uniforms, materials and lights on ``device``: as numpy
    arrays, which the plain versions read, and on a CUDA device also as a
    :data:`FRAME_DATA` record in device memory (``data``), which the
    kernels read.

    :meth:`write` packs the record into the next of ``ring`` pinned host
    buffers and copies it to ``data`` on the current stream, so launches
    queued after it read it and launches queued before it read the last
    one. A pinned buffer is packed again only after its earlier copy has
    run (an event per buffer), so the host may run ``ring - 1`` frames
    ahead of the card."""

    def __init__(self, device, ring: int = 1):
        self.device = torch.device(device)
        self.uniforms = self.mats = self.lights = None
        self.data = None
        if self.device.type == "cuda":
            self.data = torch.empty(FRAME_DATA.itemsize, dtype=torch.uint8, device=self.device)
            self._pinned = [torch.empty(FRAME_DATA.itemsize, dtype=torch.uint8, pin_memory=True)
                            for _ in range(ring)]
            self._records = [p.numpy().view(FRAME_DATA)[0] for p in self._pinned]
            self._copied = [torch.cuda.Event() for _ in range(ring)]
            self._next = 0

    def write(self, uniforms: np.ndarray, mats: np.ndarray, lights: np.ndarray) -> None:
        self.uniforms = np.asarray(uniforms, F32)
        self.mats = np.asarray(mats, F32)
        self.lights = np.asarray(lights, F32)
        if self.data is None:
            pack_frame_data(np.zeros((), FRAME_DATA), self.uniforms, self.mats, self.lights)
            return
        i = self._next
        self._next = (i + 1) % len(self._pinned)
        self._copied[i].synchronize()  # the copy from this buffer has run
        pack_frame_data(self._records[i], self.uniforms, self.mats, self.lights)
        with torch.cuda.device(self.device):
            self.data.copy_(self._pinned[i], non_blocking=True)
            self._copied[i].record()


def frame_buffer(device, uniforms: np.ndarray, mats: np.ndarray,
                 lights: np.ndarray) -> FrameBuffer:
    """A one-frame :class:`FrameBuffer` on ``device``, written."""
    fb = FrameBuffer(device)
    fb.write(uniforms, mats, lights)
    return fb


def make_frame(cfg: StaticConfig, buffer: FrameBuffer, band: int, depth: int, is_last: bool,
               n_rays: int | None = None, mx_shadow: bool = False) -> Frame:
    """The parameters of one kernel launch that reads ``buffer``'s frame
    data; ``n_rays`` is its thread count (default: the wavefront's rays in
    ``band`` rows); ``mx_shadow``: a tensor-core build's shadow rays take
    that form too (F_MX_SHADOW)."""
    aa = max(1, cfg.aa_samples)
    grid_w, grid_h = camera.aa_grid(aa)
    f = Frame()
    f.flags = config_flags(cfg) | (F_MX_SHADOW if mx_shadow else 0)
    f.width, f.height, f.band = cfg.width, cfg.height, band
    f.aa, f.grid_w, f.grid_h = aa, grid_w, grid_h
    f.aspect = float(F32(cfg.width / cfg.height))
    f.n_rays = trace_wavefront.num_rays(cfg, band) if n_rays is None else n_rays
    f.depth, f.is_last = depth, int(is_last)
    f.data = buffer.data.data_ptr()
    return f


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library (all its kernels): the
    set-up span ``cosig.setup.kernels``, once a process."""
    with trace.setup("cosig.setup.kernels"):
        return _load()


def _load() -> ctypes.CDLL:
    path, _, _ = kbuild.build()
    lib = ctypes.CDLL(path)
    # frame, geom, aabb, sb_aabb, n_clusters, k, c_pad, prims, n_sph, n_box
    common = [
        ctypes.POINTER(Frame), ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    shadow = [ptr, ptr, i32, i32, i32]  # the shadow set's geom, aabb, n_clusters, k, c_pad
    for name, extra in (
        ("cosig_primary_launch", []),  # state, stream
        ("cosig_bounce_launch", [ptr, ptr]),  # idx, n_live, state, stream
        ("cosig_primary_mx_launch", []),  # state, stream
        ("cosig_bounce_mx_launch", [ptr, ptr]),  # idx, n_live, state, stream
        ("cosig_megakernel_mx_launch", [i32]),  # max_depth, out, stream
        ("cosig_primary_form_launch", [i32] + shadow),  # fission, shadow set, state, stream
        ("cosig_bounce_shadow_launch", shadow + [ptr, ptr]),  # shadow set, idx, n_live, ...
        ("cosig_trace_launch", [ptr, ptr]),  # idx, n_live, state, stream
        ("cosig_shade_launch", [ptr, ptr]),  # idx or NULL, n_live or NULL, state, stream
        ("cosig_primary_form_mx_launch", [i32] + shadow),  # as their exact builds'
        ("cosig_bounce_shadow_mx_launch", shadow + [ptr, ptr]),
        ("cosig_trace_mx_launch", [ptr, ptr]),
        ("cosig_shade_mx_launch", [ptr, ptr]),
        ("cosig_megakernel_launch", [i32]),  # max_depth, out, stream
        ("cosig_debug_launch", [i32]),  # mode, out, stream
    ):
        fn = getattr(lib, name)
        fn.argtypes = common + extra + [ptr, ptr]
        fn.restype = i32
    # state, n, blocks, range, counts, scratch ints, idx, n_live, stream
    lib.cosig_compact_launch.argtypes = [ptr, i32, i32, i32, ptr, i32, ptr, ptr, ptr]
    lib.cosig_compact_launch.restype = i32
    # n, &blocks, &range
    lib.cosig_compact_grid.argtypes = [i32, ctypes.POINTER(i32), ctypes.POINTER(i32)]
    lib.cosig_compact_grid.restype = i32
    for name in ("cosig_tile_smem_bytes", "cosig_mx_smem_bytes", "cosig_trace_smem_bytes"):
        getattr(lib, name).argtypes = [i32]  # k
        getattr(lib, name).restype = i32
    # geom, k, rays, n, limbs, planes, stream
    lib.cosig_mx_probe_launch.argtypes = [ptr, i32, ptr, i32, ptr, ptr, ptr]
    lib.cosig_mx_probe_launch.restype = i32
    for name in ("cosig_wavefront_occupancy", "cosig_megakernel_occupancy",
                 "cosig_mx_occupancy"):
        getattr(lib, name).argtypes = [i32, i32, i32]  # which, n_clusters, k
        getattr(lib, name).restype = i32
    for name in ("cosig_form_occupancy", "cosig_mx_form_occupancy"):
        getattr(lib, name).argtypes = [i32, i32, i32, i32]  # which, n_clusters, k, shadow k
        getattr(lib, name).restype = i32
    for name, size in (("cosig_frame_bytes", ctypes.sizeof(Frame)),
                       ("cosig_frame_data_bytes", FRAME_DATA.itemsize)):
        fn = getattr(lib, name)
        fn.argtypes = []
        fn.restype = i32
        if fn() != size:
            raise RuntimeError(f"{name}: layout mismatch, C {fn()} bytes, Python {size}")
    return lib


def check_cluster_set(cset: ClusterSet, dev: torch.device, name: str = "cset") -> None:
    """Raise unless the cluster set is what the kernels read: contiguous
    float32 on ``dev``, of the layout they index, with ``geom`` 16-byte
    aligned (the block walk copies each cluster's rows with bulk async
    copies, which fault on other addresses), the superblock boxes
    ``sb_aabb_t`` [8, 128] (every kernel's superblock cull reads them)."""
    for field in ("geom", "aabb_t", "sb_aabb_t"):
        t = getattr(cset, field)
        if t.device != dev:
            raise ValueError(f"{name}.{field} is on {t.device}, expected {dev}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}.{field} must be contiguous float32")
    if cset.geom.data_ptr() % 16 != 0:
        raise ValueError(f"{name}.geom must start at a 16-byte aligned address")
    if cset.geom.dim() != 3 or cset.geom.shape[2] != GEOM_COMPS:
        raise ValueError(f"{name}.geom must be [C, K, {GEOM_COMPS}], "
                         f"got {tuple(cset.geom.shape)}")
    if cset.aabb_t.dim() != 2 or cset.aabb_t.shape[0] != 8 \
            or cset.aabb_t.shape[1] < cset.geom.shape[0]:
        raise ValueError(f"{name}.aabb_t must be [8, >= C], got {tuple(cset.aabb_t.shape)}")
    if tuple(cset.sb_aabb_t.shape) != (8, MAX_SUPERBLOCKS):
        raise ValueError(f"{name}.sb_aabb_t must be [8, {MAX_SUPERBLOCKS}], "
                         f"got {tuple(cset.sb_aabb_t.shape)}")


def check_inputs(cset: ClusterSet, dev: torch.device, prims: torch.Tensor,
                 n_sph: int, n_box: int) -> None:
    """Raise unless the cluster set and the primitive table are what the
    kernels read: the set as :func:`check_cluster_set` holds it, the table
    contiguous float32 [>= n_sph + n_box, 22] on ``dev``."""
    check_cluster_set(cset, dev)
    if (prims.device != dev or prims.dtype != torch.float32 or not prims.is_contiguous()
            or prims.dim() != 2 or prims.shape[1] != 22
            or prims.shape[0] < n_sph + n_box or min(n_sph, n_box) < 0):
        raise ValueError(
            f"prims must be contiguous float32 [>= {n_sph + n_box}, 22] on {dev}, "
            f"got {prims.dtype} {tuple(prims.shape)} on {prims.device}"
        )


def check_shadow_set(cset_shadow: ClusterSet, dev: torch.device) -> None:
    """Raise unless ``cset_shadow`` is what the kernels' shadow walk reads:
    a set as :func:`check_cluster_set` holds it, within one cull block
    (c_pad <= 512, so the walk needs no superblock cull)."""
    check_cluster_set(cset_shadow, dev, "cset_shadow")
    if int(cset_shadow.aabb_t.shape[1]) > CULL_BLOCK:
        raise ValueError(f"cset_shadow must fit one cull block of {CULL_BLOCK} clusters, "
                         f"got c_pad {int(cset_shadow.aabb_t.shape[1])}")


def shadow_args(cset_shadow) -> tuple:
    """A launcher's shadow-set arguments: (geom, aabb, n_clusters, k,
    c_pad), NULL pointers and zeros without a shadow set."""
    if cset_shadow is None:
        return None, None, 0, 0, 0
    return (cset_shadow.geom, cset_shadow.aabb_t, cset_shadow.num_clusters, cset_shadow.k,
            int(cset_shadow.aabb_t.shape[1]))


def _arg(x):
    """A launcher argument: a tensor as its device pointer, an int as is."""
    return ctypes.c_void_p(x.data_ptr()) if isinstance(x, torch.Tensor) else x


def _call(name: str, dev: torch.device, *args) -> None:
    """Call launcher ``name`` with ``args`` and the current stream of
    ``dev``; raise if the launch is refused."""
    fn = getattr(library(), name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(_arg(a) for a in args), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


def launch(name: str, frame: Frame, cset: ClusterSet, prims: torch.Tensor, n_sph: int,
           n_box: int, out: torch.Tensor, *extra) -> None:
    """Launch ``name`` on the current stream of ``out``'s device; raise if
    the launch is refused. ``extra``: the launcher's arguments between the
    primitive counts and ``out`` (ints, or tensors passed as pointers)."""
    _call(name, out.device, ctypes.byref(frame), cset.geom, cset.aabb_t, cset.sb_aabb_t,
          cset.num_clusters, cset.k, int(cset.aabb_t.shape[1]), prims, n_sph, n_box,
          *extra, out)


def check_buffer(buffer: FrameBuffer, dev: torch.device) -> None:
    """Raise unless ``buffer`` holds a written frame on ``dev``."""
    if buffer.device != dev:
        raise ValueError(f"the frame buffer is on {buffer.device}, not {dev}")
    if buffer.uniforms is None:
        raise ValueError("the frame buffer was never written")


_OCCUPANCY = {"primary": ("cosig_wavefront_occupancy", 0),
              "bounce": ("cosig_wavefront_occupancy", 1),
              "megakernel": ("cosig_megakernel_occupancy", 0),
              "debug": ("cosig_megakernel_occupancy", 1),
              "primary_shadow": ("cosig_form_occupancy", 0),
              "bounce_shadow": ("cosig_form_occupancy", 1),
              "primary_fission": ("cosig_form_occupancy", 2),
              "trace": ("cosig_form_occupancy", 3),
              "shade": ("cosig_form_occupancy", 4),
              "shade_all": ("cosig_form_occupancy", 5),
              "primary_mx": ("cosig_mx_occupancy", 0),
              "bounce_mx": ("cosig_mx_occupancy", 1),
              "megakernel_mx": ("cosig_megakernel_occupancy", 2),
              "primary_shadow_mx": ("cosig_mx_form_occupancy", 0),
              "bounce_shadow_mx": ("cosig_mx_form_occupancy", 1),
              "primary_fission_mx": ("cosig_mx_form_occupancy", 2),
              "trace_mx": ("cosig_mx_form_occupancy", 3),
              "shade_mx": ("cosig_mx_form_occupancy", 4),
              "shade_all_mx": ("cosig_mx_form_occupancy", 5)}


def occupancy(kernel: str, n_clusters: int, k: int, dev: torch.device, shadow_k: int = 0) -> int:
    """Blocks of ray kernel ``kernel`` (primary, bounce, megakernel, debug,
    the wavefront's other builds: primary_shadow, bounce_shadow,
    primary_fission, trace, shade, shade_all, and the tensor-core builds
    primary_mx, bounce_mx, megakernel_mx, primary_shadow_mx,
    bounce_shadow_mx, primary_fission_mx, trace_mx, shade_mx,
    shade_all_mx), in the build its launch picks for
    ``n_clusters`` clusters of ``k`` rows (with the superblock cull where
    :func:`~cosig_tpu_torch.accel.clusters.superblocks` is above 0, with
    slots of 128 rows where k > 128), that one multiprocessor of ``dev``
    holds at once with the block walk's shared memory (the shadow builds,
    whose walk over the shadow set's ``shadow_k`` rows has slots no larger,
    the main walk's; the exact trace its compacted walk's); raise if the
    card refuses that shared memory."""
    name, which = _OCCUPANCY[kernel]
    args = (which, n_clusters, k) + ((shadow_k,) if "form" in name else ())
    with torch.cuda.device(dev):
        blocks = getattr(library(), name)(*args)
    if blocks <= 0:
        raise RuntimeError(f"{kernel} kernel at k = {k}: CUDA error {-blocks}")
    return blocks


def mx_probe(geom: torch.Tensor, rays: torch.Tensor) -> tuple:
    """The tensor-core form's device functions on one cluster ``geom`` f32
    [k, 36] and rays f32 [6, n] (origin, direction), both contiguous on a
    card (csrc/mx.cu mx_probe_kernel) -> (limbs, planes): the geometry
    limbs as bf16 [5 k, 64] in the layout of ``clusters.pack_mx`` and the
    planes f32 [5, k, n] (va, vb, vc, s, num). A check's entry, not a
    kernel of a path: it counts no launch."""
    dev = geom.device
    for what, t in (("geom", geom), ("rays", rays)):
        if t.device != dev or dev.type != "cuda" or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.dim() != 2:
            raise ValueError(f"{what} must be a contiguous float32 matrix on a card")
    k, n = int(geom.shape[0]), int(rays.shape[1])
    if geom.shape[1] != GEOM_COMPS or rays.shape[0] != 6 or k == 0 or n == 0:
        raise ValueError(f"geom must be [k, {GEOM_COMPS}] and rays [6, n], got "
                         f"{tuple(geom.shape)} and {tuple(rays.shape)}")
    limbs = torch.zeros((5 * k, 64), dtype=torch.int16, device=dev)
    planes = torch.empty((5, k, n), dtype=torch.float32, device=dev)
    _call("cosig_mx_probe_launch", dev, geom, k, rays, n, limbs, planes)
    return limbs.view(torch.bfloat16), planes


@functools.lru_cache(maxsize=64)
def compact_grid(n: int, dev: torch.device) -> tuple:
    """(blocks, rays per block) of the compaction kernel's cooperative grid
    for ``n`` rays on ``dev``, computed from the card's occupancy once per
    (n, device) and kept; raise if no grid fits."""
    blocks, rays = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = library().cosig_compact_grid(n, ctypes.byref(blocks), ctypes.byref(rays))
    if err != 0:
        raise RuntimeError(f"cosig_compact_grid failed: CUDA error {err}")
    return blocks.value, rays.value


def launch_compact(state: torch.Tensor, idx: torch.Tensor, n_live: torch.Tensor) -> None:
    """List the live rays of ``state`` into ``idx`` and ``n_live`` (the
    compaction kernel's one cooperative launch, on the grid of
    :func:`compact_grid`), with the per-block octant counts' scratch from
    ``torch.empty``; raise if the launch is refused."""
    n = int(state.shape[1])
    blocks, rays = compact_grid(n, state.device)
    ints = OCTANTS * blocks
    counts = torch.empty(max(1, ints), dtype=torch.int32, device=state.device)
    _call("cosig_compact_launch", state.device, state, n, blocks, rays, counts, ints, idx,
          n_live)
