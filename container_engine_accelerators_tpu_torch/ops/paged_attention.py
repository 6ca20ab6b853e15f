"""Single-token paged decode attention: a hand-written CUDA kernel
(csrc/paged_attention.cu) and its plain PyTorch version.

Replaces the Pallas TPU kernel container_engine_accelerators_tpu/
ops/paged_attention.py `_paged_fn` (:93, pallas_call :196; entry
`paged_attention` :204), both its bf16/f32 path and its int8
dequant-in-kernel twin.

The kernel walks each row's block table itself and runs an online
softmax over the row's pages: K/V are read straight from the page pool,
never gathered into a dense view.  The pages of a row are split over
the blocks of one thread-block cluster (flash decoding: grid (split,
head, row)) so a decode batch fills the card, and the splits are merged
in rank order inside the same launch, through distributed shared
memory.  It is bound by bytes — one read of every visible K/V row,
streamed by cp.async through a ring of chunks — and skips chunks whose
lanes are all masked (bit-identical to folding them in), so a row costs
its visible length, not the mapped view.  Masked lanes never touch the
accumulator, so garbage in the null page 0 cannot change one output
bit.  `paged_plan` chooses the splits; see the source's header for the
thread layout.

The plain version is the gather math of the reference's transformer
path (transformer.py:242-265; the int8 form quant_generate.py:299-320):
gather the view through the block table, f32 scores with q divided by
sqrt(d), -1e30 mask fill, softmax, cast to q's type.  The wrapper takes
it only for CPU tensors; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from . import _build

MAX_HEAD_DIM = 256  # the kernel takes any head dim up to this
MAX_CLUSTER = 8  # splits of one (row, head): one portable cluster
_BLOCKS_PER_SM = 8  # blocks wanted on each SM


def paged_plan(b: int, heads: int, pages: int, sms: int):
    """(splits, pages per split) of the kernel's grid: enough splits
    (1..MAX_CLUSTER, one cluster) of each row's pages that b x heads x
    splits blocks fill a card of `sms` SMs, and no empty split."""
    target = _BLOCKS_PER_SM * sms
    want = max(1, min(pages, MAX_CLUSTER,
                      -(-target // max(1, b * heads))))
    per_split = -(-pages // want)
    return -(-pages // per_split), per_split


def check_head_dim(d: int) -> None:
    """The kernel's head-dim rule: any d from 1 to MAX_HEAD_DIM (32,
    64, 128 and 256 have instances of their own; any other d runs the
    d-256 instance with d given at run time)."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(
            f"paged_attention: d_head {d} not in 1..{MAX_HEAD_DIM}"
        )


def paged_attention_plain(q, k_pool, v_pool, block_tables, kv_mask, *,
                          k_scale=None, v_scale=None):
    """q (b, heads, d); pools (n_pages, page, heads, d) bf16/f32, or
    int8 with k_scale/v_scale (n_pages, page, heads) f32; block_tables
    (b, pages_per_row) int32; kv_mask (b, pages_per_row * page) bool.
    Returns (b, heads, d) in q's dtype."""
    b, heads, d = q.shape
    view = kv_mask.shape[1]
    g = block_tables.reshape(-1).long()
    kview = k_pool[g].reshape(b, view, heads, d).float()
    vview = v_pool[g].reshape(b, view, heads, d).float()
    qf = q.float() / (d ** 0.5)
    if k_scale is not None:
        # Dequant rides the contraction output for K and the operand
        # for V (quant_generate.py:308-320).
        ks = k_scale[g].reshape(b, view, heads)
        vs = v_scale[g].reshape(b, view, heads)
        scores = (torch.einsum("bhd,bkhd->bkh", qf, kview) * ks).permute(
            0, 2, 1
        )
        vview = vview * vs[..., None]
    else:
        scores = torch.einsum("bhd,bkhd->bhk", qf, kview)
    scores = torch.where(kv_mask[:, None, :], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p, vview).to(q.dtype)


_Q_TYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _launch(q, k_pool, v_pool, block_tables, kv_mask, k_scale, v_scale):
    quant = k_scale is not None
    q_type = _Q_TYPES.get(q.dtype)
    kv_type = _KV_TYPES.get(k_pool.dtype)
    # Built: f32/f32, bf16/bf16, and bf16 q over int8 pools (the int8
    # engine's activations are bf16).
    if (
        q_type is None or kv_type is None or v_pool.dtype != k_pool.dtype
        or (kv_type == 2) != quant
        or (kv_type != q_type if not quant else q.dtype != torch.bfloat16)
    ):
        raise ValueError(
            f"paged_attention: unsupported types q {q.dtype}, pools "
            f"{k_pool.dtype}, quant {quant}"
        )
    tensors = [q, k_pool, v_pool, block_tables, kv_mask]
    if quant:
        tensors += [k_scale, v_scale]
    for t in tensors:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(
                "paged_attention: the CUDA kernel takes CUDA tensors on "
                "one device"
            )
        if not t.is_contiguous():
            raise ValueError("paged_attention: tensors must be contiguous")
    b, heads, d = q.shape
    n_pages, page, h2, d2 = k_pool.shape
    pages = block_tables.shape[1]
    if (h2, d2) != (heads, d) or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"paged_attention: pool {tuple(k_pool.shape)} does not match "
            f"q {tuple(q.shape)}"
        )
    check_head_dim(d)
    if tuple(block_tables.shape) != (b, pages) or tuple(
        kv_mask.shape
    ) != (b, pages * page):
        raise ValueError(
            "paged_attention: block_tables must be (b, P) and kv_mask "
            "(b, P * page)"
        )
    if block_tables.dtype != torch.int32 or kv_mask.dtype != torch.bool:
        raise ValueError(
            "paged_attention: block_tables int32 and kv_mask bool"
        )
    if quant and (
        k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
        or tuple(k_scale.shape) != (n_pages, page, heads)
        or v_scale.shape != k_scale.shape
    ):
        raise ValueError(
            "paged_attention: scales must be (n_pages, page, heads) f32"
        )
    fn = _build.load("cea_paged_attention")
    splits, _ = paged_plan(b, heads, pages, _build.sm_count(q.device.index))
    out = torch.empty_like(q)
    rc = fn(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        block_tables.data_ptr(), kv_mask.data_ptr(), out.data_ptr(),
        q_type, kv_type, b, pages, page, heads, d, splits,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "paged_attention")
    _build.add_launches(paged_attention)
    return out


def paged_attention(q, k_pool, v_pool, block_tables, kv_mask, *,
                    k_scale=None, v_scale=None):
    """Single-token paged attention (signature of the reference's
    entry, without its gate flags).  CPU tensors take the plain
    version; CUDA tensors launch the kernel, or raise on a dtype, shape
    or layout it does not take."""
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, k_pool, v_pool, block_tables, kv_mask,
            k_scale=k_scale, v_scale=v_scale,
        )
    return _launch(
        q, k_pool, v_pool, block_tables, kv_mask, k_scale, v_scale
    )


paged_attention.launches = 0
