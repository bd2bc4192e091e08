"""The op census (``repro_torch.utils.census``) and the meta dispatch of
the kernel ops on the CPU: every smoke config's steps on the meta
device, a hand count of a dense prefill's FLOPs, the meta count against
the CPU count of one training step, the top-up of the recurrences
against their full count, each kernel span's work in fused mode, and
no collective. Imports neither JAX nor the JAX package."""
import pytest
import torch

from repro_torch import configs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.kernels import (decode_attn, flash_attn, mamba_scan,
                                 mlstm_scan, ops, split_quant)
from repro_torch.launch import dryrun
from repro_torch.models import lm
from repro_torch.train.step import TrainConfig
from repro_torch.utils import census as census_mod
from repro_torch.utils.census import Census

B, S = 2, 16


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _count(fn, *, fused=True, device="cpu"):
    c = Census(fused=fused, device=device)
    with c:
        out = fn()
    return c.result(), out


# ------------------------------------------------------------ the repair

@pytest.mark.parametrize("arch", configs.ASSIGNED)
def test_every_smoke_step_runs_on_meta(arch):
    """Prefill, decode step and train step of each smoke config on meta
    tensors, outside any census: every kernel op takes its plain version
    there (no CUDA wrapper is reached)."""
    cfg = configs.get_smoke(arch)
    tcfg = TrainConfig()
    for kind in ("train", "prefill", "decode"):
        run, args = dryrun.make_step(cfg, ShapeSpec(kind, S, B, kind), tcfg)
        out = run(*args)
        leaves = [t for t in torch.utils._pytree.tree_flatten(out)[0]
                  if isinstance(t, torch.Tensor)]
        assert leaves and all(t.is_meta for t in leaves), (arch, kind)


def test_quantizer_ops_run_on_meta():
    x = _meta(4, 7, 96)
    q, s = ops.quantize_boundary(x)
    assert (q.shape, q.dtype, s.shape) == ((4, 7, 96), torch.int8, (4, 7, 1))
    y = ops.ste_quantize(x)
    assert y.is_meta and y.shape == x.shape and y.dtype == x.dtype
    dec = ops.decode_attention(_meta(2, 4, 1, 32), _meta(2, 2, 9, 32),
                               _meta(2, 2, 9, 32),
                               _meta(2, dtype=torch.int32))
    assert dec.is_meta and dec.shape == (2, 4, 1, 32)


def test_wrappers_refuse_cpu_and_their_twins_take_meta_only():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        split_quant.quantize_rows(x)
    with pytest.raises(ValueError, match="meta"):
        split_quant.quantize_rows_meta(x)
    q = _meta(1, 2, 8, 16)
    o, lse = flash_attn.flash_attention_fwd_meta(q, q, q, lse=True)
    assert o.shape == q.shape and lse.shape == (1, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attn.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="head"):
        mlstm_scan.mlstm_chunk_scan_meta(
            *(_meta(1, 8, 2, 12, dtype=torch.bfloat16),) * 3,
            _meta(1, 8, 2), _meta(1, 8, 2))


# ---------------------------------------------------------------- counts

def test_dense_prefill_flops_equal_a_hand_count():
    """SmolLM's smoke config (2 layers, d 96, 3 heads of 32, 1 KV head,
    d_ff 256, vocab 512, tied head), a prefill of B x S: every matmul
    2 M N K, B2's causal band at 4 D a pair and head, in fused mode; the
    plain version's QK^T and PV over the full S x S in plain mode."""
    cfg = configs.get_smoke("smollm_360m")
    d, H, KV, dh, f, V = 96, 3, 1, 32, 256, 512
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab, cfg.n_layers) == (d, H, KV, dh, f, V, 2)
    T = B * S
    per_layer = (2 * T * d * (H + 2 * KV) * dh + 2 * T * H * dh * d
                 + 2 * T * d * 2 * f + 2 * T * f * d)
    band = 4 * dh * H * B * S * (S + 1) // 2
    head = 2 * T * d * V
    shape = ShapeSpec("prefill", S, B, "prefill")
    fused = dryrun.count_step(cfg, shape, TrainConfig()).result()
    plain = dryrun.count_step(cfg, shape, TrainConfig(),
                              fused=False).result()
    assert fused["flops"] == 2 * (per_layer + band) + head
    assert plain["flops"] == 2 * (per_layer + 2 * 2 * dh * H * B * S * S) \
        + head
    assert fused["kernels"]["flash_attn_fwd"] == {
        "launches": 2, "flops": 2 * band,
        "bytes": 2 * (2 * B * H * S * dh + 2 * B * KV * S * dh) * 2}


@pytest.mark.parametrize("fused", [True, False])
def test_meta_count_equals_cpu_count_of_a_train_step(fused):
    """One smoke training step (AdamW, remat full, bf16) counted on the
    CPU with real weights and on meta: equal FLOPs, bytes, op counts and
    launches; in plain mode also the peak (in fused mode the CPU runs each
    kernel's plain body for its values, whose allocations meta skips)."""
    cfg = configs.get_smoke("smollm_360m")
    shape = ShapeSpec("train", S, B, "train")
    g = torch.Generator().manual_seed(0)
    params = lm.init(cfg, g)
    tok = lambda: torch.randint(0, cfg.vocab, (B, S), generator=g,
                                dtype=torch.int32)
    batch = {"tokens": tok(), "labels": tok()}
    cpu = dryrun.count_step(cfg, shape, TrainConfig(), fused=fused,
                            params=params, batch=batch, device="cpu").result()
    meta = dryrun.count_step(cfg, shape, TrainConfig(), fused=fused).result()
    for key in ("flops", "bytes", "ops", "kernels", "base_bytes"):
        assert cpu[key] == meta[key], key
    assert cpu["peak_bytes"] == meta["peak_bytes"]
    assert meta["kernels"]["flash_attn_fwd"]["launches"] == (4 if fused
                                                              else 0)
    assert meta["peak_bytes"] > meta["base_bytes"] > 0


def test_peak_follows_allocations_and_frees():
    def run():
        a = torch.empty(1000, dtype=torch.float32)        # 4,000 B
        b = torch.ones(500, dtype=torch.float64)          # 4,000 B
        del a
        c = b * 2.0                                       # 4,000 B
        return c
    r, _ = _count(run)
    assert r["peak_bytes"] == 8000 and r["base_bytes"] == 0
    assert r["bytes"] == 4000 + 8000                      # ones, mul


def test_collectives_are_zero():
    r, _ = _count(lambda: torch.ones(3) @ torch.ones(3))
    assert set(r["collectives"]) == set(census_mod.COLLECTIVES)
    assert all(v == {"count": 0, "bytes": 0.0}
               for v in r["collectives"].values())


# ------------------------------------------------------------ the top-up

def _slstm_inputs(S_, d=8, grad=False):
    g = torch.Generator().manual_seed(1)
    xp = torch.randn(B, S_, 4 * d, generator=g).requires_grad_(grad)
    wh = (torch.randn(d, 4 * d, generator=g) * 0.1).requires_grad_(grad)
    zeros = lambda: torch.zeros(B, d)
    return xp, wh, zeros(), zeros(), zeros(), torch.full((B, d), -1e30)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_slstm_topup_equals_the_full_count(grad, device):
    """The sLSTM at S = 16 through ``ops.slstm_scan`` (the top-up: two
    trips + 14 x the third trip's difference, forward and backward)
    against its token loop counted op by op; on the CPU the values are
    the loop's."""
    ins = [t.detach().to(device).requires_grad_(t.requires_grad)
           for t in _slstm_inputs(S, grad=grad)]

    def run(fn):
        def go():
            h, state = fn(*ins)
            if grad:
                torch.autograd.grad(h.sum(), ins[:2])
            return h
        return go
    top, h = _count(run(ops.slstm_scan), device=device)
    full, h_full = _count(run(ops.slstm_loop), device=device)
    for key in ("flops", "bytes", "ops"):
        assert top[key] == full[key], key
    assert top["n_ops"] > 14 * S
    if device == "cpu":
        torch.testing.assert_close(h, h_full, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["mamba", "mlstm"])
def test_plain_scan_topup_equals_the_full_count(kind):
    """In plain mode the chunked scans are counted by the top-up: at 3
    chunks equal to the plain scan counted op by op, forward and
    backward."""
    g = torch.Generator().manual_seed(2)
    r = lambda *s: torch.randn(*s, generator=g)
    L = 4
    if kind == "mamba":
        ins = [r(B, 3 * L, 2, 4), r(B, 3 * L, 2).abs(), r(2), r(B, 3 * L, 4),
               r(B, 3 * L, 4)]
        via, plain = ops.mamba_scan, mamba_scan.mamba_chunk_scan_plain
    else:
        ins = [r(B, 3 * L, 2, 4) for _ in range(3)] + [r(B, 3 * L, 2),
                                                      r(B, 3 * L, 2)]
        via, plain = ops.mlstm_scan, mlstm_scan.mlstm_chunk_scan_plain
    ins = [t.requires_grad_() for t in ins]

    def run(fn):
        return lambda: torch.autograd.grad(fn(*ins, chunk=L)[0].sum(), ins)
    top, _ = _count(run(via), fused=False)
    full, _ = _count(run(plain), fused=False)
    for key in ("flops", "bytes", "ops"):
        assert top[key] == full[key], key
    assert top["plain_kernels"][f"{kind}_scan"]["calls"] == 1


# ----------------------------------------------------- the kernel spans

def _kernel_cases():
    r = lambda *s, dt=torch.float32: torch.randn(*s).to(dt)
    q, k = r(B, 4, S, 16), r(B, 2, S, 16)
    lengths = torch.tensor([5, S], dtype=torch.int32)
    x, dt = r(B, S, 2, 8), r(B, S, 2).abs()
    a, bc = r(2), r(B, S, 4)
    qm = r(B, S, 2, 8)
    im = r(B, S, 2)
    z = r(3, 5, 24)
    return [
        ("flash_attn_fwd", lambda: ops.flash_attention(q, k, k, window=5),
         flash_attn.work(q, k, window=5)),
        ("decode_attn",
         lambda: ops.decode_attention(q[:, :, :1], k, k, lengths),
         decode_attn.work(q[:, :, :1], k, 5 + S)),
        ("mamba_scan", lambda: ops.mamba_scan(x, dt, a, bc, bc, chunk=8),
         mamba_scan.work(x, dt, a, bc, bc, chunk=8)),
        ("mlstm_scan", lambda: ops.mlstm_scan(qm, qm, qm, im, im, chunk=8),
         mlstm_scan.work(qm, qm, qm, im, im, chunk=8)),
        ("split_quant", lambda: ops.quantize_boundary(z),
         split_quant.work(z, fused=False)),
        ("split_quant", lambda: ops.ste_quantize(z),
         split_quant.work(z, fused=True)),
    ]


@pytest.mark.parametrize("case", range(6))
def test_fused_span_counts_the_kernels_work_not_its_body(case):
    """Fused: one launch at the kernel's work() and no aten op of the
    plain body (on the CPU the body is the plain version, for values:
    the output equals the plain dispatch's); plain: the body op by op,
    kept as that kernel's share."""
    name, call, (nbytes, nops) = _kernel_cases()[case]
    fused, out = _count(call)
    plain, want = _count(call, fused=False)
    assert fused["kernels"][name] == {"launches": 1, "flops": nops,
                                      "bytes": nbytes}
    assert (fused["flops"], fused["bytes"]) == (nops, nbytes)
    for t, w in zip(torch.utils._pytree.tree_flatten(out)[0],
                    torch.utils._pytree.tree_flatten(ops_plain(call))[0]):
        torch.testing.assert_close(t, w, rtol=0, atol=0)
    assert all(v["launches"] == 0 for v in plain["kernels"].values())
    share = plain["plain_kernels"][name]
    if name in ("mamba_scan", "mlstm_scan"):      # the top-up's forward
        assert share["calls"] == 1 and share["bytes"] > 0
    else:
        assert (share["flops"], share["bytes"]) == (plain["flops"],
                                                    plain["bytes"])


def ops_plain(call):
    with torch.no_grad():
        return call()


def test_census_restores_ops_and_nests():
    outer = Census(device="cpu")
    with outer:
        assert ops.census is outer
        inner = Census(device="cpu")
        with inner:
            assert ops.census is inner
            torch.ones(2, 2) @ torch.ones(2, 2)
        assert ops.census is outer
    assert ops.census is None
    # the outer census sees what the inner one hands on: two ones (16 B
    # each written) and the product (32 B read, 16 written)
    for c in (inner, outer):
        assert (c.result()["flops"], c.result()["bytes"]) == (16, 80)
