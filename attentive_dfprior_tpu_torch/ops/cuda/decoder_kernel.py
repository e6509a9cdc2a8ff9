"""K2, the fused decoder MLP forward.

The port of ``attentive_dfprior_tpu/ops/pallas/decoder_kernel.py``
(``fused_mlp_forward``, ``pack_mlp_params``). For CUDA tensors the wrappers
launch the CUDA kernel (``csrc/decoder_mlp.cu``, three-pass TF32 ``wgmma``
at fp32 accuracy); for CPU tensors they run the plain version,
``mlp_decoder_forward``. Forward only: there is no gradient.

The kernel reads its weights as one float32 image (``pack_tc_weights``):
each matrix transposed (row = output feature, K contiguous), K padded to
whole k8 steps, K rows permuted to the kernel's register fragments, split
into TF32 hi and lo parts, in wgmma's no-swizzle core-matrix layout.
``TC_CACHE`` builds it once per decoder and parameter version (the leaves'
``_version``, which a CUDA graph's replay that writes them also advances,
``utils/step_graph.py``). Inside a render or point-query program
(``utils/step_graph.py:ForwardGraphs``) K2 reads a static image of the
program's instead (``StaticImages``, ``pinned_images``): a capture cannot
build one, and a graph keeps the address of the image it read.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch

from attentive_dfprior_tpu_torch.models.decoders import mlp_decoder_forward
from attentive_dfprior_tpu_torch.ops.cuda.build import CudaKernel, check_launch
from attentive_dfprior_tpu_torch.utils.profiling import span
from attentive_dfprior_tpu_torch.utils.tree import tree_leaves

EMBED = 93
HIDDEN = 32
N_BLOCKS = 5
SKIPS = (2,)
EMBED_PAD = 96  # the embedding padded to whole k8 steps


def _bind(lib: ctypes.CDLL) -> None:
    lib.decoder_mlp_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.decoder_mlp_launch.restype = ctypes.c_int
    lib.decoder_self_check.argtypes = [
        ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.decoder_self_check.restype = ctypes.c_int
    lib.decoder_mlp_smem_bytes.argtypes = [ctypes.c_int]
    lib.decoder_mlp_smem_bytes.restype = ctypes.c_longlong


KERNEL = CudaKernel("decoder_mlp", "decoder_mlp.cu", _bind)
SIN_FAST_BITS = 0x47CE4780  # 105615.0f: the kernel's branch-free sinf covers |a| below it
FINITE_BITS = 0x7F800000  # +inf: every finite float lies below it, with either sign


def self_check(device: torch.device, mode: int, first: int, count: int) -> int:
    """On the card: the number of floats, taken as the bit patterns
    [first, first + count), on which the kernel's branch-free sinf and sinf
    (mode 0), or its integer TF32 rounding and ``cvt.rna.tf32.f32`` (mode 1),
    differ. Not a launch of K2: the count stays."""
    lib = KERNEL.lib()
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        n_sm = torch.cuda.get_device_properties(device).multi_processor_count
        rc = lib.decoder_self_check(mode, first, count, bad.data_ptr(), 16 * n_sm,
                                    torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decoder_self_check: CUDA launch failed with cudaError {rc}")
    return int(bad.item())


def smem_bytes(c_dim: int) -> int:
    """The kernel's dynamic shared memory per CTA at ``c_dim`` (its weight
    image and the c stages of its warpgroups), from the built library."""
    return int(KERNEL.lib().decoder_mlp_smem_bytes(c_dim))


class PackedMLP(NamedTuple):
    """pack_mlp_params output: the JAX package's 5-tuple."""

    B: torch.Tensor  # (3, EMBED)
    Wcat: torch.Tensor  # (314 + 5c, HIDDEN): W_i | fc_c[i] row blocks
    bcat: torch.Tensor  # (2 * N_BLOCKS, HIDDEN): pts / fc bias pairs
    Wout: torch.Tensor  # (HIDDEN, out_dim)
    bout: torch.Tensor  # (out_dim,)


def pack_mlp_params(params: Dict[str, Any]) -> PackedMLP:
    """Pack a decoder tree in the Pallas kernel's layout."""
    rows, biases = [], []
    for i in range(N_BLOCKS):
        rows += [params["pts"][i]["w"], params["fc_c"][i]["w"]]
        biases += [params["pts"][i]["b"], params["fc_c"][i]["b"]]
    return PackedMLP(
        params["B"], torch.cat(rows, dim=0), torch.stack(biases, dim=0),
        params["out"]["w"], params["out"]["b"],
    )


def _row_offsets(c_dim: int):
    offs, cur = [], 0
    for i in range(N_BLOCKS):
        w_rows = EMBED if i == 0 else (HIDDEN + EMBED if i - 1 in SKIPS else HIDDEN)
        offs.append((cur, w_rows))
        cur += w_rows
        offs.append((cur, c_dim))
        cur += c_dim
    return offs, cur


def unpack_mlp_params(packed: PackedMLP, c_dim: int) -> Dict[str, Any]:
    """Decoder tree whose leaves are views into the packed weights."""
    offs, _ = _row_offsets(c_dim)
    pts, fc_c = [], []
    for i in range(N_BLOCKS):
        (wo, wr), (fo, fr) = offs[2 * i], offs[2 * i + 1]
        pts.append({"w": packed.Wcat[wo : wo + wr], "b": packed.bcat[2 * i]})
        fc_c.append({"w": packed.Wcat[fo : fo + fr], "b": packed.bcat[2 * i + 1]})
    return {"B": packed.B, "pts": pts, "fc_c": fc_c, "out": {"w": packed.Wout, "b": packed.bout}}


def fused_mlp_plain(packed: PackedMLP, p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Plain version: ``mlp_decoder_forward`` on the packed weights, (N, out)."""
    out = mlp_decoder_forward(unpack_mlp_params(packed, c.shape[-1]), p, c)
    return out[:, None] if out.ndim == 1 else out


# ---------------------------------------------------------------------------
# The kernel's weight image
# ---------------------------------------------------------------------------


def n_tc_weights(c_dim: int) -> int:
    """Floats in the kernel's weight image (``decoder_mlp.cu:n_weights``):
    hi and lo of [W0 | W3e] (64 x 96), [fc0..fc4] (160 x c) and the four
    chain matrices (32 x 32), then B (3 x 96), the ten biases, Wout (32 x 4)
    and bout (4)."""
    return 2 * (2 * HIDDEN * EMBED_PAD + 5 * HIDDEN * c_dim + 4 * HIDDEN * HIDDEN) + (
        3 * EMBED_PAD + 2 * N_BLOCKS * HIDDEN + 4 * HIDDEN + 4
    )


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on the float32 bit pattern: round to 10
    mantissa bits, ties away from zero; the low 13 bits become 0."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """x -> (hi, lo), both TF32 values, hi + lo within 2^-21 of x."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def chain_k_order() -> torch.Tensor:
    """K position -> feature of the chain products' A fragments: a thread's
    accumulator columns 8kk + 2t and 8kk + 2t + 1 feed A positions 8kk + t
    and 8kk + t + 4."""
    pos = torch.arange(HIDDEN)
    kk, q = pos // 8, pos % 8
    return 8 * kk + 2 * (q % 4) + q // 4


def fc_k_order(c_dim: int) -> torch.Tensor:
    """K position -> feature of the fc product's A fragments: thread t holds
    features t * c/4 .. t * c/4 + c/4 - 1 of its rows, two per k8 step."""
    pos = torch.arange(c_dim)
    kk, q = pos // 8, pos % 8
    return (q % 4) * (c_dim // 4) + 2 * kk + q // 4


def _core_matrices(wt: torch.Tensor) -> torch.Tensor:
    """(rows, K) -> flat, in 128-byte core matrices of 8 rows x 4 K values:
    element (n, k) at ((n // 8) * (K // 4) + k // 4) * 32 + (n % 8) * 4 + k % 4."""
    rows, k = wt.shape
    return wt.reshape(rows // 8, 8, k // 4, 4).permute(0, 2, 1, 3).reshape(-1)


def pack_tc_weights(packed: PackedMLP) -> torch.Tensor:
    """The kernel's float32 weight image (``decoder_mlp.cu`` layout), on the
    weights' device."""
    c_dim = (packed.Wcat.shape[0] - 314) // 5
    tree = unpack_mlp_params(packed, c_dim)
    w = [blk["w"].float() for blk in tree["pts"]]
    fc = [blk["w"].float() for blk in tree["fc_c"]]
    dev = packed.B.device

    def pad_k(wt: torch.Tensor, k: int) -> torch.Tensor:
        return torch.nn.functional.pad(wt, (0, k - wt.shape[1]))

    we = torch.cat([pad_k(w[0].T, EMBED_PAD), pad_k(w[3][:EMBED].T, EMBED_PAD)])  # (64, 96)
    wf = torch.cat([f.T for f in fc])[:, fc_k_order(c_dim).to(dev)]  # (160, c)
    chain = [w[1], w[2], w[3][EMBED:], w[4]]
    wc = [m.T[:, chain_k_order().to(dev)] for m in chain]  # 4 x (32, 32)
    parts: List[torch.Tensor] = []
    for m in (we, wf, *wc):  # each hi matrix followed by its lo matrix
        parts += tf32_split(_core_matrices(m.contiguous()))
    wout = packed.Wout.float()
    parts += [
        pad_k(packed.B.float(), EMBED_PAD).reshape(-1),
        packed.bcat.float().reshape(-1),
        pad_k(wout, 4).reshape(-1),
        pad_k(packed.bout.float().reshape(1, -1), 4).reshape(-1),
    ]
    flat = torch.cat(parts).contiguous()
    assert flat.numel() == n_tc_weights(c_dim)
    return flat


# images held at once: a process runs three decoders, and in the async
# modes the tracker's scene snapshot holds three more, so 2 x 3 = 6 are live
TC_CACHE_SIZE = 8


class _TcCache:
    """Weight images by decoder (a decoder tree or a ``PackedMLP``): an
    entry holds the decoder's leaf tensors (compared with ``is``) and each
    leaf's ``_version``, so an in-place update (the optimizer's ``copy_``,
    a graph replay that writes the scene) or a replaced leaf (a checkpoint
    load) builds a new image.

    Thread-safe: ``get`` runs under one lock, the build included, so two
    threads asking for one decoder build one image. An image is built on
    the caller's current stream, and on CUDA an event is recorded there;
    a caller on another stream waits for that event and records its stream
    on the image, so the allocator does not reuse the image's memory while
    that stream may still read it."""

    def __init__(self):
        self.entries: List[tuple] = []  # (leaves, versions, image, stream, event), newest last
        self.builds = 0
        self._lock = threading.Lock()

    def get(self, weights) -> torch.Tensor:
        packed = isinstance(weights, PackedMLP)
        leaves = list(weights) if packed else tree_leaves(weights)
        versions = [t._version for t in leaves]
        with self._lock:
            for i, (held, vers, image, stream, event) in enumerate(self.entries):
                if len(held) == len(leaves) and all(a is b for a, b in zip(held, leaves)):
                    if vers == versions:
                        self.entries.append(self.entries.pop(i))
                        if event is not None:
                            here = torch.cuda.current_stream(image.device)
                            if here != stream:
                                here.wait_event(event)
                                image.record_stream(here)
                        return image
                    del self.entries[i]  # same decoder, older parameters
                    break
            with torch.no_grad():
                image = pack_tc_weights(weights if packed else pack_mlp_params(weights))
            stream = event = None
            if image.is_cuda:
                stream = torch.cuda.current_stream(image.device)
                event = torch.cuda.Event()
                event.record(stream)
            self.builds += 1
            self.entries.append((leaves, versions, image, stream, event))
            del self.entries[:-TC_CACHE_SIZE]
            return image


TC_CACHE = _TcCache()  # the weight images of every decoder the process runs through K2

_PINNED = threading.local()


@contextlib.contextmanager
def pinned_images(pins: Sequence[Tuple[List[torch.Tensor], torch.Tensor]]) -> Iterator[None]:
    """Within the block (on this thread), K2 reads a decoder whose leaves
    are ``leaves`` (compared with ``is``) from ``image`` for each
    (leaves, image) of ``pins``, and never asks ``TC_CACHE``: a program's
    static images, kept current outside its capture."""
    prev = getattr(_PINNED, "pins", ())
    _PINNED.pins = tuple(pins)
    try:
        yield
    finally:
        _PINNED.pins = prev


def _pinned(leaves: List[torch.Tensor]) -> Optional[torch.Tensor]:
    for held, image in getattr(_PINNED, "pins", ()):
        if len(held) == len(leaves) and all(a is b for a, b in zip(held, leaves)):
            return image
    return None


class StaticImages:
    """The static K2 weight images of one captured program, one per decoder
    tree in ``decoders`` (the program's static scene).

    ``TC_CACHE`` builds a new image tensor whenever a decoder's leaves
    change (the mapper writes them between two renders), and a build
    copies index tables from the host, which no capture allows; a graph
    bakes in the address of the image it read. So the program reads images
    of its own: ``refresh``, called outside any capture before the program
    runs, asks the cache for each decoder's current image and copies it
    into the static image when it is not the image last copied; within
    ``pinned()`` K2 reads the static images."""

    def __init__(self, decoders: Sequence[Any]):
        self.decoders = list(decoders)
        self.images: List[torch.Tensor] = []
        self._copied: List[Optional[torch.Tensor]] = []  # the cache's image last copied into each
        self.copies = 0

    def refresh(self) -> None:
        with span("StaticImages.refresh") as s, torch.no_grad():
            before = self.copies
            for i, dec in enumerate(self.decoders):
                image = TC_CACHE.get(dec)
                if i == len(self.images):
                    self.images.append(torch.empty_like(image))
                    self._copied.append(None)
                elif self.images[i].shape != image.shape:
                    raise ValueError(f"K2 weight image of {tuple(image.shape)} for a program captured at "
                                     f"{tuple(self.images[i].shape)}")
                if self._copied[i] is not image:
                    self.images[i].copy_(image)
                    self._copied[i] = image
                    self.copies += 1
            if s is not None:
                s.attrs["copies"] = self.copies - before

    def pinned(self) -> contextlib.AbstractContextManager:
        return pinned_images([(tree_leaves(d), im) for d, im in zip(self.decoders, self.images)])


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _check(name: str, p: torch.Tensor, c: torch.Tensor, weights: List[torch.Tensor], out_dim: int) -> None:
    """Raise on what the kernel does not take."""
    n, c_dim = c.shape
    for t in (p, c, *weights):
        if t.device != p.device:
            raise ValueError(f"{name}: tensor on {t.device}, p on {p.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: tensors must be float32, got {t.dtype}")
    if tuple(p.shape) != (n, 3) or c_dim not in (32, 64) or out_dim not in (1, 4):
        raise ValueError(f"{name}: unsupported shapes p {tuple(p.shape)}, c {tuple(c.shape)}, out {out_dim}")
    if not (p.is_contiguous() and c.is_contiguous()):
        raise ValueError(f"{name}: p and c must be contiguous")
    if c.data_ptr() % 16:
        raise ValueError(f"{name}: c must be 16-byte aligned (cp.async rows)")


def fused_mlp_forward(packed: PackedMLP, p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Run the decoder MLP over N points (the JAX function's signature).

    Args:
        packed: pack_mlp_params output.
        p: (N, 3) points; c: (N, c_dim) sampled grid features, c_dim 32 or 64.

    Returns:
        (N, out_dim) head outputs, out_dim 1 or 4.
    """
    if p.device.type == "cpu":
        return fused_mlp_plain(packed, p, c)
    return _cuda_forward("fused_mlp_forward", packed, p, c)


def fused_decoder_forward(params: Dict[str, Any], p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``fused_mlp_forward`` on a decoder tree; (N, out_dim)."""
    if p.device.type == "cpu":
        out = mlp_decoder_forward(params, p, c)
        return out[:, None] if out.ndim == 1 else out
    return _cuda_forward("fused_decoder_forward", params, p, c)


def _cuda_forward(name: str, weights, p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The entry points' CUDA path: K2 on the pinned image
    (``pinned_images``) or the weight image from ``TC_CACHE`` (built once
    per decoder and parameter version)."""
    if p.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {p.device}")
    packed = isinstance(weights, PackedMLP)
    out_dim = (weights.Wout if packed else weights["out"]["w"]).shape[-1]
    leaves = list(weights) if packed else tree_leaves(weights)
    _check(name, p, c, leaves, out_dim)
    image = _pinned(leaves)
    return fused_mlp_launch(TC_CACHE.get(weights) if image is None else image, p, c, out_dim)


def fused_mlp_launch(w: torch.Tensor, p: torch.Tensor, c: torch.Tensor, out_dim: int) -> torch.Tensor:
    """Launch the kernel on a weight image (``pack_tc_weights``) and checked
    CUDA inputs (the entry points do the checks); (N, out_dim)."""
    n, c_dim = c.shape
    if w.device != p.device or w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError(f"fused_mlp_launch: weights must be contiguous float32 on {p.device}")
    if w.numel() != n_tc_weights(c_dim):
        raise ValueError(f"fused_mlp_launch: weight image of {w.numel()} floats, c_dim {c_dim} takes {n_tc_weights(c_dim)}")
    out = torch.empty((n, out_dim), dtype=torch.float32, device=p.device)
    if n == 0:
        return out
    lib = KERNEL.lib()
    with torch.cuda.device(p.device):
        n_sm = torch.cuda.get_device_properties(p.device).multi_processor_count
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.decoder_mlp_launch(
            p.data_ptr(), c.data_ptr(), w.data_ptr(), out.data_ptr(),
            n, c_dim, out_dim, w.numel(), n_sm, stream,
        )
    check_launch(KERNEL, rc)
    return out
