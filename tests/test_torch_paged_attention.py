"""The port's paged-attention op (container_engine_accelerators_tpu_torch/
ops/paged_attention.py) against the reference's Pallas kernel, run in
interpret mode as the reference's own suite runs it, and against the
reference's gather math, at the layout corners of
tests/test_paged_attention.py: a visibility ending on a page boundary,
an unmapped block-table tail (null page 0), and a physical page shared
by two rows.  On the CPU the wrapper takes its plain version; the CUDA
kernel is held against that plain version on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # caps torch's CPU threads
from container_engine_accelerators_tpu.ops import paged_attention as PA
from container_engine_accelerators_tpu_torch.ops import _build
from container_engine_accelerators_tpu_torch.ops import (
    paged_attention as TPA,
)

PAGE = 8
ATOL = 2e-6  # the reference suite's own f32 bound for this op


def _mk_case(seed, b=3, pages_per_row=4, page=PAGE, heads=2, d=16,
             n_pages=16):
    """Row 0 fully visible, row 1's visibility ending exactly on a page
    boundary, row 2 sharing row 0's first physical page with an
    unmapped tail (the null page 0)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, heads, d)).astype(np.float32)
    k = rng.standard_normal((n_pages, page, heads, d)).astype(np.float32)
    v = rng.standard_normal((n_pages, page, heads, d)).astype(np.float32)
    bt = np.arange(1, 1 + b * pages_per_row, dtype=np.int32).reshape(
        b, pages_per_row
    )
    bt[2, 0] = bt[0, 0]
    bt[2, 2:] = 0
    view = pages_per_row * page
    pos = np.array([view - 1, 2 * page - 1, page + 3])
    mask = np.arange(view)[None, :] <= pos[:, None]
    return q, k, v, bt, mask


def _quantize(pool):
    """Per-(page, slot, head) symmetric int8, the quant pool layout."""
    scale = (np.abs(pool).max(-1) / 127.0 + 1e-8).astype(np.float32)
    ints = np.round(pool / scale[..., None]).astype(np.int8)
    return ints, scale


def _gather_ref(q, k, v, bt, mask, ks=None, vs=None):
    """The reference's gather math in JAX (transformer.py:242-265; the
    int8 form quant_generate.py:299-320)."""
    b, heads, d = q.shape
    view = mask.shape[1]
    g = bt.reshape(-1)
    kview = jnp.asarray(k)[g].reshape((b, view, heads, d)).astype(
        jnp.float32
    )
    vview = jnp.asarray(v)[g].reshape((b, view, heads, d)).astype(
        jnp.float32
    )
    qf = jnp.asarray(q) / (d ** 0.5)
    if ks is not None:
        kss = jnp.asarray(ks)[g].reshape((b, view, heads))
        scores = (jnp.einsum("bhd,bkhd->bkh", qf, kview) * kss).transpose(
            0, 2, 1
        )
        vview = vview * jnp.asarray(vs)[g].reshape((b, view, heads))[
            ..., None
        ]
    else:
        scores = jnp.einsum("bhd,bkhd->bhk", qf, kview)
    scores = jnp.where(jnp.asarray(mask)[:, None, :], scores, -1e30)
    p = jax.nn.softmax(scores, axis=-1)
    return np.asarray(jnp.einsum("bhk,bkhd->bhd", p, vview))


def _port(q, k, v, bt, mask, ks=None, vs=None):
    t = torch.from_numpy
    return TPA.paged_attention(
        t(q), t(k), t(v), t(bt), t(mask),
        k_scale=None if ks is None else t(ks),
        v_scale=None if vs is None else t(vs),
    ).numpy()


class TestPlainAgainstReference:
    @pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_matches_pallas_interpret_and_gather(self, quant, seed):
        q, k, v, bt, mask = _mk_case(seed)
        ks = vs = None
        if quant:
            k, ks = _quantize(k)
            v, vs = _quantize(v)
        jk = PA.paged_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(bt), jnp.asarray(mask),
            k_scale=None if ks is None else jnp.asarray(ks),
            v_scale=None if vs is None else jnp.asarray(vs),
            force=True, interpret=True,
        )
        assert jk is not None
        got = _port(q, k, v, bt, mask, ks, vs)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(jk), rtol=0, atol=ATOL)
        np.testing.assert_allclose(
            got, _gather_ref(q, k, v, bt, mask, ks, vs), rtol=0, atol=ATOL
        )

    def test_bf16_output_dtype_and_gather_parity(self):
        q, k, v, bt, mask = _mk_case(5)
        t = torch.from_numpy
        out = TPA.paged_attention(
            t(q).bfloat16(), t(k).bfloat16(), t(v).bfloat16(), t(bt),
            t(mask),
        )
        assert out.dtype == torch.bfloat16
        ref = _gather_ref(
            np.asarray(t(q).bfloat16().float()),
            np.asarray(t(k).bfloat16().float()),
            np.asarray(t(v).bfloat16().float()), bt, mask,
        )
        # Both sum in f32; the port rounds once to bf16 (2**-8 relative).
        np.testing.assert_allclose(
            out.float().numpy(), ref, rtol=2 ** -8, atol=2 ** -8
        )

    @pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
    def test_poisoned_null_page_is_bitwise_invisible(self, quant):
        q, k, v, bt, mask = _mk_case(3)
        ks = vs = None
        if quant:
            k, ks = _quantize(k)
            v, vs = _quantize(v)
        clean = _port(q, k, v, bt, mask, ks, vs)
        pk, pv = k.copy(), v.copy()
        pk[0] = 99 if quant else 999.0
        pv[0] = -99 if quant else -777.0
        if quant:
            ks, vs = ks.copy(), vs.copy()
            ks[0], vs[0] = 1e4, 1e4
        poisoned = _port(q, pk, pv, bt, mask, ks, vs)
        assert clean.tobytes() == poisoned.tobytes()

    def test_shared_pages_are_read_only(self):
        q, k, v, bt, mask = _mk_case(4)
        before = k.copy(), v.copy()
        _port(q, k, v, bt, mask)
        assert np.array_equal(k, before[0]) and np.array_equal(v, before[1])


@pytest.mark.parametrize("d", [1, 3, 32, 64, 80, 96, 100, 128, 256])
def test_head_dim_rule_accepts_any_d_up_to_256(d):
    # The kernel serves every head dim the reference serves up to 256:
    # 32 / 64 / 128 / 256 by their own instances, any other by the
    # d-256 instance at run time.
    TPA.check_head_dim(d)


@pytest.mark.parametrize("d", [0, 257, 512])
def test_head_dim_rule_rejects_past_256_by_name(d):
    with pytest.raises(ValueError, match=r"d_head .* not in 1\.\.256"):
        TPA.check_head_dim(d)


@pytest.mark.parametrize("d", [96, 100])
def test_plain_matches_gather_at_other_head_dims(d):
    # The head dims that only the run-time instance serves on the card
    # (d 100: rows that are no whole number of 16-byte pieces).
    q, k, v, bt, mask = _mk_case(7, d=d)
    k, ks = _quantize(k)
    v, vs = _quantize(v)
    np.testing.assert_allclose(
        _port(q, k, v, bt, mask, ks, vs),
        _gather_ref(q, k, v, bt, mask, ks, vs), rtol=0, atol=ATOL,
    )


class TestNoFallback:
    def test_non_cpu_tensor_never_takes_the_plain_version(self):
        # A tensor off the CPU goes to the kernel path, which takes only
        # CUDA tensors: it raises instead of computing the plain math.
        q, k, v, bt, mask = (
            torch.from_numpy(a).to("meta") for a in _mk_case(0)
        )
        before = TPA.paged_attention.launches
        with pytest.raises(ValueError, match="CUDA"):
            TPA.paged_attention(q, k, v, bt, mask)
        assert TPA.paged_attention.launches == before

    def test_f32_query_over_int8_pools_raises(self):
        # The int8 kernel is built for bf16 queries only: an f32 query
        # over int8 pools is refused before anything launches.
        q, k, v, bt, mask = (
            torch.from_numpy(a).to("meta") for a in _mk_case(0)
        )
        k8, v8 = k.to(torch.int8), v.to(torch.int8)
        scale = torch.ones(k.shape[:3], device="meta")
        before = TPA.paged_attention.launches
        with pytest.raises(ValueError, match="unsupported types"):
            TPA.paged_attention(q, k8, v8, bt, mask, k_scale=scale,
                                v_scale=scale)
        assert TPA.paged_attention.launches == before

    def test_missing_toolkit_raises_at_build(self, monkeypatch, tmp_path):
        # Where no kernel is built and nvcc is absent, loading the
        # kernel raises; the wrapper has no path around it.
        monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
        monkeypatch.setattr(_build, "CUDA_HOME", str(tmp_path / "cuda"))
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
        monkeypatch.setattr(_build, "_libs", {})
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.load("cea_paged_attention")


@pytest.mark.parametrize(
    "b,heads,pages", [(16, 8, 20), (1, 8, 20), (3, 2, 4), (64, 16, 2)]
)
@pytest.mark.parametrize("sms", _torch_port.H100_SMS)
def test_paged_plan_covers_every_page_once(b, heads, pages, sms):
    # The kernel's cluster over a row's pages: block r covers logical
    # pages [r * per_split, (r + 1) * per_split), so every page belongs
    # to exactly one split, no split is empty and the cluster holds 1-8
    # blocks, whatever the batch.
    splits, per_split = TPA.paged_plan(b, heads, pages, sms)
    assert 1 <= splits <= 8
    covered = np.zeros(pages, np.int64)
    for r in range(splits):
        assert r * per_split < pages
        covered[r * per_split:(r + 1) * per_split] += 1
    assert (covered == 1).all()
