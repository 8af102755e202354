"""Shared-prefix rollout decode attention (counterpart of
``qaig_tpu/ops/decode_attention.py``).

One rollout decode step: the B rollouts of image n attend in one float32
softmax over the image's SHARED prefix (slots ``< index0`` of slot-minor
(N, H, dh, S) caches) and over their own segment (slots
``<= block_index`` of (N*B, H, bw, dh) blocks).

* :func:`shared_prefix_attention_fused_t` -- prefix in the working dtype
  (kernel B);
* :func:`shared_prefix_attention_fused_int8` -- int8 prefix with per-slot
  bf16 scales (N, H, S) folded into the scores (K) and the probabilities
  (V) (kernel C).

Layout.  The caches stay slot-minor, (N, H, dh, S), as in the JAX package,
and one kernel (``qaig_tpu_torch/csrc/decode_attention.cu``,
``prefix_split_kernel``, templated on the prefix element type) reads that
layout directly for both: it cuts each (image, head) prefix into the slot
ranges of :func:`launch_plan` and runs one cluster of CTAs per (image,
head), each CTA streaming its range with 16-byte copies (an int8 tile with
its scales) and the cluster combining the partial softmax states through
distributed shared memory (deterministic, one launch).

On CUDA tensors both functions launch the kernel; on
CPU tensors they run :func:`shared_prefix_attention_reference`, the plain
PyTorch version.
A CUDA input the kernel does not take raises.  Any ``bw >= 1`` is taken,
including crossing segments whose width is not a multiple of 8.

Interleaved layout (the engine's ``flat_decode`` option):
:func:`shared_prefix_attention_fused_flat` computes the same function over
prefix caches stored (N, dh, S*H), column = slot*H + head (built once per
segment by :func:`interleave_t` / :func:`interleave_scale`), with per-column
int8 scales (N, S*H).  Its kernel
(``qaig_tpu_torch/csrc/decode_attention_flat.cu``) cuts each image's
prefix into the slot ranges of :func:`flat_launch_plan`, one CTA per range
covering all heads (so each d-row of a slot tile is one contiguous run),
streams them with 16-byte copies, and combines the CTAs' softmax states in
rank order inside the same launch.  Its plain version,
:func:`shared_prefix_attention_flat_reference`, rounds where the TPU kernel
does (pre-scaled q and the probabilities in the working dtype), not where
kernel B does.
"""

import ctypes
import functools
import math

import torch

from qaig_tpu_torch.ops import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SPLIT_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 14
                   + [ctypes.c_void_p])
_MAX_SMEM = 227 * 1024


def shared_prefix_attention_reference(q, k_shared, v_shared, k_block,
                                      v_block, index0, block_index,
                                      k_scale=None, v_scale=None):
    """Plain PyTorch version (the JAX package's einsum path,
    ``qaig_tpu/ops/attention.py:200-240``), computed in float32.

    q (N*B, 1, D); k_shared/v_shared (N, H, dh, S) (int8 with
    ``k_scale``/``v_scale`` (N, H, S)); k_block/v_block (N*B, H, bw, dh).
    Returns (N*B, 1, D) in q's dtype."""
    nb, _, d = q.shape
    n, heads, dh, s = k_shared.shape
    b = nb // n
    bw = k_block.shape[2]
    scale = 1.0 / math.sqrt(dh)
    f32 = torch.float32

    qh = q.to(f32).reshape(nb, heads, dh)                   # (N*B, H, dh)
    qg = qh.reshape(n, b, heads, dh)
    s_shared = torch.einsum("nbhd,nhds->nbhs", qg,
                            k_shared.to(f32)) * scale
    if k_scale is not None:
        s_shared = s_shared * k_scale.to(f32)[:, None]
    s_shared = s_shared.reshape(nb, heads, s)
    live = torch.arange(s, device=q.device) < index0
    s_shared = s_shared.masked_fill(~live, float("-inf"))

    s_block = torch.einsum("rhd,rhtd->rht", qh, k_block.to(f32)) * scale
    live_b = torch.arange(bw, device=q.device) <= block_index
    s_block = s_block.masked_fill(~live_b, float("-inf"))

    weights = torch.softmax(torch.cat([s_shared, s_block], dim=-1), dim=-1)
    w_shared = weights[..., :s].reshape(n, b, heads, s)
    if v_scale is not None:
        w_shared = w_shared * v_scale.to(f32)[:, None]
    out = torch.einsum("nbhs,nhds->nbhd", w_shared,
                       v_shared.to(f32)).reshape(nb, heads, dh)
    out = out + torch.einsum("rht,rhtd->rhd", weights[..., s:],
                             v_block.to(f32))
    return out.reshape(nb, 1, d).to(q.dtype)


def shared_prefix_attention_fused_t(q, kt_shared, vt_shared, k_block,
                                    v_block, index0, block_index):
    """Rollout decode attention over a working-dtype prefix (kernel B on
    CUDA tensors).  ``index0``/``block_index`` are Python ints."""
    if q.device.type == "cpu":
        return shared_prefix_attention_reference(
            q, kt_shared, vt_shared, k_block, v_block, index0, block_index)
    out = _launch_split(q, kt_shared, vt_shared, k_block, v_block, index0,
                        block_index)
    shared_prefix_attention_fused_t.launches += 1
    return out


shared_prefix_attention_fused_t.launches = 0


def shared_prefix_attention_fused_int8(q, k8t_shared, k_scale, v8t_shared,
                                       v_scale, k_block, v_block, index0,
                                       block_index):
    """Rollout decode attention over an int8 prefix with per-slot scales
    (kernel C on CUDA tensors: kernel B's kernel over int8 tiles).
    ``index0``/``block_index`` are Python ints."""
    if q.device.type == "cpu":
        return shared_prefix_attention_reference(
            q, k8t_shared, v8t_shared, k_block, v_block, index0,
            block_index, k_scale=k_scale, v_scale=v_scale)
    out = _launch_split(q, k8t_shared, v8t_shared, k_block, v_block, index0,
                        block_index, k_scale=k_scale, v_scale=v_scale)
    shared_prefix_attention_fused_int8.launches += 1
    return out


shared_prefix_attention_fused_int8.launches = 0

# the geometry of kernels B and C (decode_attention.cu: kSlots, the ring,
# split_smem)
SPLIT_SLOTS = 64        # prefix slots per ring tile
# CTAs a cluster (decode_attention.cu: kMaxSplits): on the H100 clusters
# of 4 and 8 ran slower than pairs at every timed shape (PERF.md)
SPLIT_MAX = 2
SPLIT_MIN_SLOTS = 32    # fewest prefix slots worth a CTA of their own
# ring slots (kMaxStages): two were as fast as three or four, or faster, at
# every shape swept on the H100, and leave room for two CTAs an SM
SPLIT_MAX_STAGES = 2
_SM_SMEM = 228 * 1024   # shared memory of an SM (1 KB of it reserved a CTA)
_SM_CTAS = 2            # CTAs an SM holds by registers (128 a thread)


def _split_floats(b, dh):
    b4 = -(-b // 4) * 4
    g4, parts = b4 // 4, 1
    while parts < 8 and 2 * parts * g4 <= 8:
        parts *= 2
    f = dh * b4 + b * dh + parts * b4 * SPLIT_SLOTS + 3 * b4
    return -(-f // 4) * 4


def _part_bytes(b, dh, itemsize, prefix_itemsize):
    """Bytes of a ring slot's K (or V) part: a prefix tile of dh rows of
    64 slots (pitch 64 slots + 16 bytes; an int8 tile's 64 bf16 scales
    after it) or a segment chunk's rows, the larger, in 16-byte units."""
    prefix = (dh * (SPLIT_SLOTS * prefix_itemsize + 16)
              + (2 * SPLIT_SLOTS if prefix_itemsize == 1 else 0))
    return -(-max(prefix, b * (dh * itemsize + 16)) // 16) * 16


def segment_chunk(b, dh, itemsize, prefix_itemsize=None):
    """Segment slots of all ``b`` rollouts one ring slot holds
    (``prefix_itemsize``: 1 for an int8 prefix; ``itemsize`` by
    default)."""
    pi = prefix_itemsize or itemsize
    return min(SPLIT_SLOTS, _part_bytes(b, dh, itemsize, pi)
               // (b * (dh * itemsize + 16)))


def split_smem(b, dh, itemsize, stages, prefix_itemsize=None):
    """Shared memory of one CTA of kernel B (or, with ``prefix_itemsize``
    1, C): ``split_smem`` of the source."""
    pi = prefix_itemsize or itemsize
    return _split_floats(b, dh) * 4 + stages * 2 * _part_bytes(b, dh,
                                                                itemsize, pi)


@functools.lru_cache(maxsize=4096)
def _plan(n, b, heads, dh, index0, sm_count, itemsize, block_index,
          splits, prefix_itemsize=None):
    """:func:`launch_plan`; ``splits`` 1 or 2 forces the split (phase 3 of
    ``chip_smoke.py`` times the one the plan did not take), 0 chooses."""
    pi = prefix_itemsize or itemsize
    chunks = -(-(block_index + 1) // segment_chunk(b, dh, itemsize, pi))

    def chunk_of(s):
        return -(-(-(-index0 // s)) // 8) * 8

    def geometry(splits):
        chunk = max(chunk_of(splits), 1)
        ranges = [(r * chunk, min(index0, (r + 1) * chunk))
                  for r in range(splits)]
        # the busiest rank's tiles: its prefix tiles and its share of the
        # segment's chunks (rank r: r, r + splits, ...)
        tiles = max(-(-(hi - lo) // SPLIT_SLOTS) + -(-(chunks - r) // splits)
                    for r, (lo, hi) in enumerate(ranges))
        stages = max(1, min(SPLIT_MAX_STAGES, tiles))
        while stages > 1 and split_smem(b, dh, itemsize, stages,
                                        pi) > _MAX_SMEM:
            stages -= 1
        smem = split_smem(b, dh, itemsize, stages, pi)
        per_sm = max(1, min(_SM_CTAS, _SM_SMEM // (smem + 1024)))
        return {"splits": splits, "chunk": chunk, "ranges": ranges,
                "stages": stages, "smem": smem, "ctas": n * heads * splits,
                "waves": -(-n * heads * splits // (sm_count * per_sm))}

    if splits:
        if (not 1 <= splits <= SPLIT_MAX
                or (splits > 1 and (splits - 1) * chunk_of(splits) >= index0)):
            raise ValueError(f"launch_plan: no split of index0 {index0} in "
                             f"{splits} non-empty ranges")
        return geometry(splits)
    plan = geometry(1)
    want = -(-sm_count // max(1, n * heads))
    while plan["splits"] < min(want, SPLIT_MAX) and (
            index0 >= 2 * plan["splits"] * SPLIT_MIN_SLOTS
            or (chunks >= 2 * plan["splits"]
                and index0 >= 2 * plan["splits"] * 8)):
        wider = geometry(2 * plan["splits"])
        if (wider["waves"] > 1
                or -(-index0 // wider["chunk"]) != wider["splits"]):
            break
        plan = wider
    return plan


def launch_plan(n, b, heads, dh, index0, sm_count, itemsize=2,
                block_index=0, prefix_itemsize=None):
    """The split of each (image, head) prefix for kernel B (prefix in the
    working dtype of ``itemsize`` bytes) or, with ``prefix_itemsize`` 1,
    kernel C (int8 prefix), from the shape alone.

    ``splits`` (1 or 2) CTAs form one cluster per (image, head) and
    rank r streams prefix slots ``ranges[r]``: contiguous, in order,
    covering [0, index0) exactly once, none empty, each a multiple of 8
    slots long but the last (an int8 range that starts mid-chunk reads from
    the chunk's start and masks the slots before it).  The segment (slots
    0 .. ``block_index`` of every rollout) is cut in chunks of
    :func:`segment_chunk` slots, dealt to the ranks in turn.  The split is the fewest CTAs that give each of the
    card's ``sm_count`` SMs one (at most ``SPLIT_MAX``), where each CTA
    keeps at least ``SPLIT_MIN_SLOTS`` prefix slots, or 8 and two segment
    chunks, and every CTA runs in one wave
    (``waves``: of the CTAs an SM holds by shared memory and registers, at
    this form's own shared memory; a second wave measured slower than no
    split): a short prefix (index0 1) takes one CTA, whose range may be
    empty only when index0 is 0.  ``stages`` ring slots (at most
    ``SPLIT_MAX_STAGES``, at most the busiest rank's tiles, fewer where
    shared memory would not hold them); ``smem`` is a CTA's shared memory.
    The returned dict is shared: copy it to change it."""
    return _plan(int(n), int(b), int(heads), int(dh), int(index0),
                 int(sm_count), int(itemsize), int(block_index), 0,
                 int(prefix_itemsize or itemsize))


_checked = set()


def _check_plan(q, b, dh, plan, quant):
    """Once per shape and geometry: the plan's shared memory is the
    kernel's (``split_smem`` is written in the source and mirrored here),
    within a block's, and the card holds a cluster of ``splits`` CTAs of
    it (``cudaOccupancyMaxActiveClusters``)."""
    name = ("shared_prefix_attention_fused_int8" if quant
            else "shared_prefix_attention_fused_t")
    key = (q.device.index, b, dh, q.dtype, quant, plan["splits"],
           plan["stages"])
    if key in _checked:
        return
    elem = q.element_size()
    smem = cuda_build.function(
        "decode_attention", "qaig_prefix_split_smem", [ctypes.c_int] * 5,
        ctypes.c_size_t)(b, dh, elem, 1 if quant else elem, plan["stages"])
    if smem != plan["smem"]:
        raise RuntimeError(f"{name}: the plan's shared memory {plan['smem']}"
                           f" is not the kernel's {smem}")
    if smem > _MAX_SMEM:
        raise ValueError(
            f"{name}: {b} rollouts x dh {dh} need {smem} bytes of shared "
            f"memory, above the {_MAX_SMEM} a block has")
    fn = cuda_build.function("decode_attention",
                             "qaig_prefix_split_max_clusters",
                             [ctypes.c_int] * 6)
    with torch.cuda.device(q.device):
        clusters = fn(b, dh, _DTYPES[q.dtype], int(quant), plan["splits"],
                      plan["stages"])
    if clusters < 1:
        raise RuntimeError(f"{name}: the card holds no cluster of "
                           f"{plan['splits']} CTAs at {smem} bytes "
                           f"(cudaOccupancyMaxActiveClusters: {clusters})")
    _checked.add(key)


def _aligned(*tensors):
    return all(x.data_ptr() % 16 == 0 for x in tensors)


def _launch_split(q, k_shared, v_shared, k_block, v_block, index0,
                  block_index, plan=None, k_scale=None, v_scale=None):
    """Kernel B (C with ``k_scale``/``v_scale`` and an int8 prefix) in
    :func:`launch_plan`'s geometry, or in ``plan`` (a ``_plan`` of another
    split, for timing); not counted."""
    _check_kernel_inputs(q, k_shared, v_shared, k_scale, v_scale, k_block,
                         v_block, index0, block_index)
    quant = k_scale is not None
    n, heads, dh, s = k_shared.shape
    b = q.shape[0] // n
    elem = q.element_size()
    pelem = k_shared.element_size()
    if plan is None:
        plan = launch_plan(n, b, heads, dh, index0,
                           cuda_build.sm_count(q.device), elem, block_index,
                           pelem)
    _check_plan(q, b, dh, plan, quant)
    prefix = (k_shared, v_shared) + ((k_scale, v_scale) if quant else ())
    vec = (int(s * pelem % 16 == 0 and (not quant or s * 2 % 16 == 0)
               and _aligned(*prefix))
           | 2 * int(dh * elem % 16 == 0 and _aligned(k_block, v_block)))
    out = torch.empty_like(q)
    fn = cuda_build.function("decode_attention",
                             "qaig_prefix_split_attention", _SPLIT_ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_shared.data_ptr(), v_shared.data_ptr(),
                 k_scale.data_ptr() if quant else None,
                 v_scale.data_ptr() if quant else None,
                 k_block.data_ptr(), v_block.data_ptr(), out.data_ptr(),
                 n, b, heads, dh, s, k_block.shape[2], int(index0),
                 int(block_index), plan["splits"], plan["chunk"],
                 plan["stages"], vec, _DTYPES[q.dtype], int(quant),
                 cuda_build.stream_handle(q))
    cuda_build.check("decode_attention", err)
    return out


def _check_tensors(name, q, prefix, k_scale, v_scale, k_block, v_block):
    """Device, dtype and contiguity of a decode kernel's inputs; ``prefix``
    names the two prefix caches."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{name}: unsupported dtype {q.dtype}")
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError(f"{name}: give both k_scale and v_scale or neither")
    prefix_dtype = torch.int8 if quant else q.dtype
    tensors = [("q", q, q.dtype)]
    tensors += [(tname, x, prefix_dtype) for tname, x in prefix]
    tensors += [("k_block", k_block, q.dtype), ("v_block", v_block, q.dtype)]
    if quant:
        tensors += [("k_scale", k_scale, torch.bfloat16),
                    ("v_scale", v_scale, torch.bfloat16)]
    for tname, x, dtype in tensors:
        if x.device != q.device:
            raise ValueError(f"{name}: {tname} is on {x.device}, q on "
                             f"{q.device}")
        if x.dtype != dtype:
            raise ValueError(f"{name}: {tname} must be {dtype}, got "
                             f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {tname} is not contiguous")


def _check_kernel_inputs(q, k_shared, v_shared, k_scale, v_scale, k_block,
                         v_block, index0, block_index):
    name = "shared_prefix_attention"
    _check_tensors(name, q, [("k_shared", k_shared), ("v_shared", v_shared)],
                   k_scale, v_scale, k_block, v_block)
    quant = k_scale is not None
    if k_shared.ndim != 4 or q.ndim != 3 or q.shape[1] != 1:
        raise ValueError(
            f"{name}: expected q (N*B, 1, D) and slot-minor prefix "
            f"(N, H, dh, S), got q {tuple(q.shape)}, prefix "
            f"{tuple(k_shared.shape)}")
    n, heads, dh, s = k_shared.shape
    nb, _, d = q.shape
    if d != heads * dh or nb % n:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit prefix "
                         f"{tuple(k_shared.shape)}")
    if v_shared.shape != k_shared.shape:
        raise ValueError(f"{name}: v_shared shape {tuple(v_shared.shape)} "
                         f"!= k_shared {tuple(k_shared.shape)}")
    if quant and (k_scale.shape != (n, heads, s)
                  or v_scale.shape != (n, heads, s)):
        raise ValueError(f"{name}: scales must be (N, H, S) = "
                         f"{(n, heads, s)}")
    _check_blocks(name, k_block, v_block, nb, heads, dh, s, index0,
                  block_index)


def _check_blocks(name, k_block, v_block, nb, heads, dh, s, index0,
                  block_index):
    if (k_block.ndim != 4 or k_block.shape[:2] != (nb, heads)
            or k_block.shape[3] != dh or v_block.shape != k_block.shape):
        raise ValueError(
            f"{name}: blocks must be (N*B, H, bw, dh) = "
            f"({nb}, {heads}, bw, {dh}), got {tuple(k_block.shape)} / "
            f"{tuple(v_block.shape)}")
    bw = k_block.shape[2]
    if not (0 <= int(index0) <= s and 0 <= int(block_index) < bw):
        raise ValueError(f"{name}: index0 {index0} / block_index "
                         f"{block_index} outside prefix {s} / block {bw}")


# ---------------------------------------------------------------------------
# interleaved (N, dh, S*H) prefix: the flat kernel
# ---------------------------------------------------------------------------

NEG = -1e30
_FLAT_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 16
                  + [ctypes.c_float, ctypes.c_void_p])


def flat_segment_supported(heads, num_beam, block_width):
    """Whether the engine routes a rollout segment to the flat kernel
    (``qaig_tpu/ops/decode_attention.py::flat_segment_supported``): at most
    64 rows (heads x rollouts) and a block width that is a positive
    multiple of 8.  These were the TPU compiler's limits; the port keeps
    them as the routing rule so that both engines route (and count) the
    same segments.  The Hopper kernel itself takes any ``bw >= 1``."""
    return (heads * num_beam <= 64
            and block_width > 0
            and block_width % 8 == 0)


def interleave_t(x_t):
    """(N, H, dh, S) -> interleaved (N, dh, S*H), column = slot*H + head
    (a contiguous copy)."""
    n, h, dh, s = x_t.shape
    return x_t.permute(0, 2, 3, 1).reshape(n, dh, s * h)


def interleave_scale(scale_t):
    """(N, H, S) per-slot scales -> (N, S*H)."""
    n, h, s = scale_t.shape
    return scale_t.permute(0, 2, 1).reshape(n, s * h)


def shared_prefix_attention_flat_reference(q, k_il, v_il, k_block, v_block,
                                           index0, block_index, heads,
                                           k_scale=None, v_scale=None):
    """Plain PyTorch version of the flat kernel, rounding where
    ``_kernel_flat`` (``qaig_tpu/ops/decode_attention.py:202-276``) does:
    q pre-scaled by 1/sqrt(dh) in float32 and rounded back to the working
    dtype (q's); invalid slots at -1e30; the K scales multiply the float32
    scores, the V scales the probabilities; the probabilities are rounded to
    the working dtype before both P.V products, whose float32 sum is divided
    by the float32 denominator.  Only each row's own head and own rollout
    are computed: the TPU kernel's cross-head and cross-rollout products
    are masked to exp(-1e30 - m) = 0 and add nothing.

    q (N*B, 1, D); k_il/v_il (N, dh, S*H) (int8 with ``k_scale``/``v_scale``
    (N, S*H)); k_block/v_block (N*B, H, bw, dh).  Returns (N*B, 1, D) in
    q's dtype."""
    nb, _, d = q.shape
    n, dh, sh = k_il.shape
    h, b, s = heads, nb // n, sh // heads
    wd, f32 = q.dtype, torch.float32

    def rounded(x):          # to the working dtype, computed in float32
        return x.to(wd).to(f32)

    q4 = q.reshape(n, b, h, dh).transpose(1, 2)              # (N, H, B, dh)
    q4 = rounded(q4.to(f32) / math.sqrt(dh))
    k = k_il.to(wd).to(f32).reshape(n, dh, s, h)
    v = v_il.to(wd).to(f32).reshape(n, dh, s, h)
    sc_s = torch.einsum("nhbd,ndsh->nhbs", q4, k)
    if k_scale is not None:
        sc_s = sc_s * k_scale.to(f32).reshape(n, s, h).transpose(1, 2)[
            :, :, None]
    live = torch.arange(s, device=q.device) < index0
    sc_s = sc_s.masked_fill(~live, NEG)

    kb = k_block.reshape(n, b, h, -1, dh).transpose(1, 2).to(f32)
    vb = v_block.reshape(n, b, h, -1, dh).transpose(1, 2).to(f32)
    sc_b = torch.einsum("nhbd,nhbtd->nhbt", q4, kb)
    live_b = torch.arange(kb.shape[3], device=q.device) <= block_index
    sc_b = sc_b.masked_fill(~live_b, NEG)

    m = torch.maximum(sc_s.amax(-1), sc_b.amax(-1))[..., None]
    p_s = torch.exp(sc_s - m)
    p_b = torch.exp(sc_b - m)
    denom = p_s.sum(-1) + p_b.sum(-1)
    if v_scale is not None:
        p_s = p_s * v_scale.to(f32).reshape(n, s, h).transpose(1, 2)[
            :, :, None]
    out = (torch.einsum("nhbs,ndsh->nhbd", rounded(p_s), v)
           + torch.einsum("nhbt,nhbtd->nhbd", rounded(p_b), vb))
    out = out / denom[..., None]
    return out.transpose(1, 2).reshape(nb, 1, d).to(wd)


def shared_prefix_attention_fused_flat(q, k_il, v_il, k_block, v_block,
                                       index0, block_index, heads,
                                       k_scale=None, v_scale=None):
    """Rollout decode attention over interleaved (N, dh, S*H) prefix caches
    (the flat kernel on CUDA tensors; with ``k_scale``/``v_scale`` an int8
    prefix, dequantized in the kernel).  ``index0``/``block_index`` are
    Python ints.  Launches count in ``.launches`` (working-dtype prefix)
    and ``.int8_launches``."""
    if q.device.type == "cpu":
        return shared_prefix_attention_flat_reference(
            q, k_il, v_il, k_block, v_block, index0, block_index, heads,
            k_scale=k_scale, v_scale=v_scale)
    out = _launch_flat(q, k_il, v_il, k_scale, v_scale, k_block, v_block,
                       index0, block_index, heads)
    if k_scale is None:
        shared_prefix_attention_fused_flat.launches += 1
    else:
        shared_prefix_attention_fused_flat.int8_launches += 1
    return out


shared_prefix_attention_fused_flat.launches = 0
shared_prefix_attention_fused_flat.int8_launches = 0


# the flat kernel's geometry (decode_attention_flat.cu)
FLAT_MAX_TILE = 64      # slots of a ring tile (kMaxTile)
FLAT_THREADS = 512      # threads a CTA (kThreads): one CTA an SM
FLAT_MAX_SPLITS = 8     # CTAs an image, one cluster (kMaxSplits)
# SMs that clusters of 4 or 8 one-CTA-an-SM blocks fill on the H100:
# cudaOccupancyMaxActiveClusters gives 30 and 15 there, not 33 and 16
# (clusters stay inside a GPC); the plan keeps every cluster in one wave
FLAT_CLUSTER_SMS = 120


def _flat_parts(b, heads, dh, tile):
    colwarps = -(-(tile * heads // 2) // 32)
    units = colwarps * -(-b // 4)
    parts = 1
    while parts < 8 and units * parts < FLAT_THREADS // 32 and 2 * parts <= dh:
        parts *= 2
    return parts


def _flat_part_bytes(b, heads, dh, tile, itemsize, prefix_itemsize):
    cw = tile * heads
    prefix = (dh * (cw * prefix_itemsize + 16)
              + (2 * cw if prefix_itemsize == 1 else 0))
    return -(-max(prefix, b * heads * (dh * itemsize + 16)) // 16) * 16


def flat_segment_chunk(b, heads, dh, tile, itemsize, prefix_itemsize):
    """Segment slots of every (rollout, head) one ring part of the flat
    kernel holds (1 .. ``tile``)."""
    return min(tile, _flat_part_bytes(b, heads, dh, tile, itemsize,
                                      prefix_itemsize)
               // (b * heads * (dh * itemsize + 16)))


def flat_smem(b, heads, dh, tile, itemsize, prefix_itemsize, stages):
    """Shared memory of one flat-kernel CTA of ``b`` rollouts
    (``flat_smem`` of the source): q and the accumulator (dh x H *
    ceil4(b) floats each), the score strips, m / l / alpha, the combine's
    weights and ``stages`` ring slots."""
    hb4 = heads * -(-b // 4) * 4
    floats = (2 * dh * (hb4 + 4) + _flat_parts(b, heads, dh, tile) * tile
              * (hb4 + 4) + (3 + FLAT_MAX_SPLITS + 1) * hb4)
    return (-(-floats // 4) * 4 * 4
            + stages * 2 * _flat_part_bytes(b, heads, dh, tile, itemsize,
                                            prefix_itemsize))


@functools.lru_cache(maxsize=4096)
def _flat_plan(n, b, heads, dh, index0, sm_count, itemsize, block_index,
               q_itemsize, splits=0):
    """:func:`flat_launch_plan`; ``splits`` > 0 forces the CTAs an image
    (phase 3 of ``chip_smoke.py`` times a split the plan did not take)."""
    align = 16 // math.gcd(16, heads * itemsize)
    step = align * 2 // math.gcd(align, 2)      # tiles: even, aligned
    forced = bool(splits)
    if forced:
        if not 1 <= splits <= FLAT_MAX_SPLITS:
            raise ValueError(f"flat_launch_plan: {splits} CTAs an image, "
                             f"above the {FLAT_MAX_SPLITS} of a cluster")
    else:
        held = FLAT_CLUSTER_SMS * sm_count // 132
        splits = FLAT_MAX_SPLITS
        while splits > 1 and n * splits > held:
            splits //= 2
        splits = max(1, min(splits, -(-index0 // align)))
    chunk = (-(-(-(-index0 // splits)) // align) * align) if index0 else 1
    if splits > 1 and (not index0 or -(-index0 // chunk) != splits):
        if forced:
            raise ValueError(f"flat_launch_plan: no split of index0 "
                             f"{index0} in {splits} non-empty ranges")
        splits = -(-index0 // chunk)
    ranges = [(r * chunk, min(index0, (r + 1) * chunk))
              for r in range(splits)]
    bc = b
    while True:   # all rollouts in a CTA, or the most its memory holds
        groups = -(-b // bc)
        best = None
        for tile in range(step, FLAT_MAX_TILE + 1, step):
            tc = flat_segment_chunk(bc, heads, dh, tile, q_itemsize, itemsize)
            chunks = -(-(block_index + 1) // tc)
            tiles = max(-(-(hi - lo) // tile)
                        + max(0, -(-(chunks - r) // splits))
                        for r, (lo, hi) in enumerate(ranges))
            stages = max(1, min(2, tiles))
            while stages > 1 and flat_smem(bc, heads, dh, tile, q_itemsize,
                                           itemsize, stages) > _MAX_SMEM:
                stages -= 1
            smem = flat_smem(bc, heads, dh, tile, q_itemsize, itemsize,
                             stages)
            if smem > _MAX_SMEM:
                continue
            ctas = n * groups * splits
            waves = -(-ctas // sm_count)
            # fewest waves; a ring that overlaps copies with use; fewest
            # tiles for the busiest CTA; the narrowest tile
            key = (waves, stages < min(2, tiles), tiles, tile)
            if best is None or key < best[0]:
                best = (key, {"splits": splits, "chunk": chunk,
                              "ranges": ranges, "rollouts": bc,
                              "groups": groups, "tile": tile,
                              "stages": stages, "smem": smem,
                              "segment_chunk": tc, "tiles": tiles,
                              "ctas": ctas, "waves": waves})
        if best is not None or bc == 1:
            break
        bc = -(-bc // 2)
    if best is None:
        raise ValueError(
            f"shared_prefix_attention_fused_flat: {heads} heads x dh {dh} "
            f"need {flat_smem(1, heads, dh, step, q_itemsize, itemsize, 1)} "
            f"bytes of shared memory even at one rollout and {step} slots a "
            f"tile, above the {_MAX_SMEM} a block has")
    return best[1]


def flat_launch_plan(n, b, heads, dh, index0, sm_count, itemsize,
                     block_index, q_itemsize=None):
    """The flat kernel's geometry, from the shape alone.  ``itemsize`` is
    the prefix's element size (1 for int8), ``q_itemsize`` that of q and
    the blocks (``itemsize`` by default, bf16 for an int8 prefix).

    Each image's prefix slots [0, index0) go to ``splits`` CTAs, one
    cluster, as ``ranges``: contiguous, in rank order, covering [0,
    index0) once, none empty (one empty range only at index0 0), each
    starting on a 16-byte chunk of the interleaved rows (a multiple of
    16 / gcd(16, H * itemsize) slots).  ``splits`` is the most (at most 8,
    no more than the prefix has such chunks) whose clusters the card holds
    in one wave (``FLAT_CLUSTER_SMS`` of 132 SMs, scaled to
    ``sm_count``), halving from 8.  A CTA takes all B rollouts, or
    ``rollouts`` of them in ``groups`` where its shared memory cannot hold
    them all (wide fans that the engine does not route here).  The
    segment (slots 0 .. ``block_index`` of every (rollout, head)) is cut in
    chunks of ``segment_chunk`` slots, dealt to the CTAs in turn.
    ``tile`` (even, at most ``FLAT_MAX_TILE`` slots) is chosen for the
    fewest waves, then a two-slot ring where the busiest CTA has two tiles
    or more, then its fewest ring tiles (``tiles``), then the narrowest;
    ``stages`` ring slots; ``smem`` a CTA's shared memory.  The returned
    dict is shared: copy it to change it."""
    qi = int(q_itemsize or (2 if itemsize == 1 else itemsize))
    return _flat_plan(int(n), int(b), int(heads), int(dh), int(index0),
                      int(sm_count), int(itemsize), int(block_index), qi)


_flat_checked = set()


def _check_flat_plan(q, heads, dh, plan, quant):
    """Once per shape and geometry: the plan's shared memory is the
    kernel's, and the card holds a cluster of it."""
    name = "shared_prefix_attention_fused_flat"
    key = (q.device.index, plan["rollouts"], heads, dh, q.dtype, quant,
           plan["tile"], plan["splits"], plan["stages"])
    if key in _flat_checked:
        return
    elem = q.element_size()
    smem = cuda_build.function(
        "decode_attention_flat", "qaig_flat_attention_smem",
        [ctypes.c_int] * 7, ctypes.c_size_t)(
            plan["rollouts"], heads, dh, plan["tile"], elem,
            1 if quant else elem, plan["stages"])
    if smem != plan["smem"]:
        raise RuntimeError(f"{name}: the plan's shared memory {plan['smem']}"
                           f" is not the kernel's {smem}")
    fn = cuda_build.function("decode_attention_flat",
                             "qaig_flat_attention_max_clusters",
                             [ctypes.c_int] * 8)
    with torch.cuda.device(q.device):
        clusters = fn(plan["rollouts"], heads, dh, plan["tile"],
                      _DTYPES[q.dtype], int(quant), plan["splits"],
                      plan["stages"])
    if clusters < 1:
        raise RuntimeError(f"{name}: the card holds no cluster of "
                           f"{plan['splits']} CTAs at {smem} bytes "
                           f"(cudaOccupancyMaxActiveClusters: {clusters})")
    _flat_checked.add(key)


def _launch_flat(q, k_il, v_il, k_scale, v_scale, k_block, v_block, index0,
                 block_index, heads, plan=None):
    """The flat kernel in :func:`flat_launch_plan`'s geometry, or in
    ``plan`` (a ``_flat_plan`` of another split, for timing); not
    counted."""
    name = "shared_prefix_attention_fused_flat"
    quant = k_scale is not None
    _check_flat_inputs(name, q, k_il, v_il, k_scale, v_scale, k_block,
                       v_block, index0, block_index, heads)
    n, dh, sh = k_il.shape
    s = sh // heads
    b = q.shape[0] // n
    elem = q.element_size()
    pelem = k_il.element_size()
    if plan is None:
        plan = flat_launch_plan(n, b, heads, dh, index0,
                                cuda_build.sm_count(q.device), pelem,
                                block_index, elem)
    _check_flat_plan(q, heads, dh, plan, quant)
    prefix = (k_il, v_il) + ((k_scale, v_scale) if quant else ())
    vec = (int(sh * pelem % 16 == 0 and _aligned(*prefix))
           | 2 * int(dh * elem % 16 == 0 and _aligned(k_block, v_block)))
    out = torch.empty_like(q)
    fn = cuda_build.function("decode_attention_flat", "qaig_flat_attention",
                             _FLAT_ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_il.data_ptr(), v_il.data_ptr(),
                 k_scale.data_ptr() if quant else None,
                 v_scale.data_ptr() if quant else None,
                 k_block.data_ptr(), v_block.data_ptr(), out.data_ptr(),
                 n, b, plan["rollouts"], heads, dh, s, k_block.shape[2],
                 int(index0), int(block_index), plan["splits"],
                 plan["chunk"], plan["tile"], plan["stages"], vec,
                 _DTYPES[q.dtype], int(quant), float(math.sqrt(dh)),
                 cuda_build.stream_handle(q))
    cuda_build.check("decode_attention_flat", err)
    return out


def _check_flat_inputs(name, q, k_il, v_il, k_scale, v_scale, k_block,
                       v_block, index0, block_index, heads):
    _check_tensors(name, q, [("k_il", k_il), ("v_il", v_il)], k_scale,
                   v_scale, k_block, v_block)
    quant = k_scale is not None
    if (k_il.ndim != 3 or q.ndim != 3 or q.shape[1] != 1 or heads < 1
            or k_il.shape[2] % heads):
        raise ValueError(
            f"{name}: expected q (N*B, 1, D) and an interleaved prefix "
            f"(N, dh, S*H) with H = {heads}, got q {tuple(q.shape)}, prefix "
            f"{tuple(k_il.shape)}")
    n, dh, sh = k_il.shape
    nb, _, d = q.shape
    if d != heads * dh or nb % n:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit prefix "
                         f"{tuple(k_il.shape)} with {heads} heads")
    if v_il.shape != k_il.shape:
        raise ValueError(f"{name}: v_il shape {tuple(v_il.shape)} != k_il "
                         f"{tuple(k_il.shape)}")
    if quant and (k_scale.shape != (n, sh) or v_scale.shape != (n, sh)):
        raise ValueError(f"{name}: scales must be (N, S*H) = {(n, sh)}")
    _check_blocks(name, k_block, v_block, nb, heads, dh, sh // heads,
                  index0, block_index)
