"""The DeepSeek-V3-style decoder's parts on the card (marker `card`,
skipped without CUDA): the flash kernels at MLA's widths (q and k 192
wide, v 128, on the (192, 128) instance) forward and backward against
the plain path, through autograd and alone with v the strided view of
a (b, s, h, 256) kv tensor, at seq 1024, 1088 (a
multiple of 64, not of 128) and 8192, the backward twice for bitwise
equality; the grouped expert product (ops/grouped_mm.py) against per-expert
matmuls; and one training step of 2 layers (the dense one and a MoE
one) at the published widths against the float32 reference
(port_bench/reference/moonlight.py) through the benchmark's driver.  Run
them on the card with
`python -m pytest tests/test_torch_mla_moe_card.py -m card`.  This file
imports no JAX.

Tolerances are relative Frobenius gaps of bf16 work against f32 work:
bf16 keeps 8 bits, so one rounding is ~2e-3 relative and a sum of many
rounded products ~1e-2; 2e-2 holds the products here (the plain path
rounds its output and inputs to bf16 as the kernel does), and a fault
(a wrong scale, a dropped column, a lost group) reads 0.1 and more."""

import pytest
import torch

from container_engine_accelerators_tpu_torch.ops import flash_attention as FA
from container_engine_accelerators_tpu_torch.ops import grouped_mm as GM
from port_bench import spec
from port_bench.drivers import train_moe

TOL = 2e-2
WIDE = (192, 128)  # the flash instance latent attention runs


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: runs on an NVIDIA card")


def _rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm())


@pytest.mark.card
def test_flash_at_mla_widths_against_the_plain_path():
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    b, s, h = 2, 1024, 16

    def draw(d):
        return torch.randn(b, s, h, d, device="cuda",
                           generator=g).bfloat16().requires_grad_(True)

    q, k, v = draw(192), draw(192), draw(128)
    native = (FA.flash_attention_fwd.by_instance.get(WIDE, 0),
              FA.flash_attention_bwd.by_instance.get(WIDE, 0))
    out = FA.flash_causal_attention(q, k, v)
    assert out.shape == (b, s, h, 128)
    dout = torch.randn(out.shape, device="cuda", generator=g).bfloat16()
    out.backward(dout)
    got = (out, q.grad, k.grad, v.grad)
    q2, k2, v2 = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    want = FA.causal_attention_plain(q2, k2, v2)
    want.backward(dout)
    for name, x, y in zip(("out", "dq", "dk", "dv"), got,
                          (want, q2.grad, k2.grad, v2.grad)):
        assert _rel(x, y) < TOL, name
    assert FA.flash_attention_fwd.launches > 0
    assert FA.flash_attention_fwd.by_instance[WIDE] == native[0] + 1
    assert FA.flash_attention_bwd.by_instance[WIDE] == native[1] + 1


@pytest.mark.card
@pytest.mark.parametrize("s", [1024, 1088, 8192])
def test_native_mla_instance_against_the_plain_path(s):
    """The (192, 128) kernels alone at b 1, h 16: v read in place as
    kv[..., 128:] of a (b, s, h, 256) tensor, out / dq / dk / dv against
    the plain path, two backward runs bitwise equal, and the launches
    counted under the instance."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(s)
    b, h = 1, 16

    def draw(d):
        return torch.randn(b, s, h, d, device="cuda", generator=g).bfloat16()

    q, k, kv = draw(192), draw(192), draw(256)
    v = kv[..., 128:]
    assert v.stride() == (s * h * 256, h * 256, 256, 1)
    dout = draw(128)
    before = (FA.flash_attention_fwd.by_instance.get(WIDE, 0),
              FA.flash_attention_bwd.by_instance.get(WIDE, 0))
    out, lse = FA.flash_attention_fwd(q, k, v)
    grads = FA.flash_attention_bwd(q, k, v, out, lse, dout)
    again = FA.flash_attention_bwd(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    assert out.shape == (b, s, h, 128) and out.is_contiguous()
    assert [tuple(x.shape) for x in grads] == [
        (b, s, h, 192), (b, s, h, 192), (b, s, h, 128)]
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    assert (FA.flash_attention_fwd.by_instance[WIDE],
            FA.flash_attention_bwd.by_instance[WIDE]) == (
                before[0] + 1, before[1] + 2)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    want = FA.causal_attention_plain(*leaves)
    want_grads = torch.autograd.grad(want, leaves, dout)
    for name, x, y in zip(("out", "dq", "dk", "dv"), (out, *grads),
                          (want, *want_grads)):
        assert _rel(x, y) < TOL, name


@pytest.mark.card
def test_grouped_expert_product_against_per_expert_matmuls():
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(1)
    D, F = 2048, 1408
    counts = [7000, 0, 5000, 9000, 6000, 8000, 6152, 8000]
    offs = torch.tensor(counts, device="cuda").cumsum(0).to(torch.int32)
    n = sum(counts)
    x = torch.randn(n, D, device="cuda", generator=g).bfloat16()
    w = (torch.randn(8, D, 2 * F, device="cuda", generator=g)
         / D ** 0.5).bfloat16()
    x.requires_grad_(True)
    w.requires_grad_(True)
    y = GM.grouped_mm(x, w, offs)
    dy = torch.randn(y.shape, device="cuda", generator=g).bfloat16()
    y.backward(dy)
    lo, outs = 0, []
    for e, c in enumerate(counts):
        outs.append(x[lo:lo + c].detach() @ w[e].detach())
        lo += c
    assert _rel(y, torch.cat(outs)) < TOL
    xs = x.detach().split(counts)
    dys = dy.split(counts)
    dw = torch.stack([a.t() @ d for a, d in zip(xs, dys)])
    assert _rel(w.grad, dw) < TOL
    assert torch.all(w.grad[1] == 0)  # the expert no row chose
    dx = torch.cat([d @ w[e].detach().t() for e, d in enumerate(dys)])
    assert _rel(x.grad, dx) < TOL


@pytest.mark.card
def test_two_layer_step_at_published_widths_against_the_reference():
    _need_card()
    bench = spec.Bench()
    cell = bench.cell("moonlight.train8k")
    cfg = dict(bench.config(cell), num_hidden_layers=2)
    mix = dict(bench.traffic(cell), batch=1, seq_len=2048)
    run = train_moe.TrainMoE(cfg, mix, 2 ** 31 + 5, "cuda")
    try:
        run.setup()
    finally:
        run.close()
    rows, ok, readings = run.check()
    assert ok, rows
