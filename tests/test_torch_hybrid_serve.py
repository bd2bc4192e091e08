"""The port's serving engines on Zamba2 (Mamba-2 blocks + the shared
attention block) against the JAX engines at the smoke config in f32
from the reference's weights: unsplit and split at unit 1, bulk prefill
that leaves other slots' recurrent state alone, the engine's weight cast
in bf16, and the serving CLI."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import jax_tree_to_numpy, np32
from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models.layers import Ctx as JCtx
from repro.serve.engine import DecodeEngine as JDecodeEngine
from repro.serve.engine import Request as JRequest
from repro.serve_fleet.engine import SplitDecodeEngine as JSplitDecodeEngine
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.models.layers import Ctx
from repro_torch.models.param import from_jax_params
from repro_torch.serve.engine import F32_LEAVES, DecodeEngine, Request
from repro_torch.serve_fleet.engine import SplitDecodeEngine

ARCH = "zamba2_1_2b"
KW = dict(n_slots=3, s_max=32)
# bf16 prefill logits, port vs reference: both round activations to bf16,
# at places that differ (the scan's and the matmuls' f32 sums are taken
# in other orders, so single values land 1 ulp apart) and the differences
# travel through both units; the same bound chip_smoke holds the kernel
# path to (3% of the largest logit).
BF16_LOGITS_TOL_OF_MAX = 0.03


def _tree(seed=0):
    """The reference's smoke weights as numpy, with a_log and dt_bias
    drawn off their constant init so that rounding them would show."""
    tree = jax_tree_to_numpy(jlm.init(jconfigs.get_smoke(ARCH),
                                      jax.random.key(seed)))
    rng = np.random.default_rng(seed + 5)
    m = tree["units"]["0:mamba2"]["mamba"]
    for name in ("a_log", "dt_bias"):
        m[name] = (rng.standard_normal(m[name].shape) * 0.5).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def model():
    tree = _tree()
    return (jconfigs.get_smoke(ARCH), jax.tree.map(jnp.asarray, tree),
            configs.get_smoke(ARCH), from_jax_params(tree))


def _prompts(n=5, seed=0):
    """Prompts of lengths 2..6 so the slots finish at different steps."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, 2 + i).astype(np.int32) for i in range(n)]


def _port(engine_cls, cfg, params, prompts, new=6, **kw):
    eng = engine_cls(cfg, params, act_dtype=torch.float32, device="cpu",
                     **{**KW, **kw})
    return eng.submit_and_run([Request(rid=i, prompt=p, max_new_tokens=new)
                               for i, p in enumerate(prompts)])


def _jax(engine_cls, cfg, params, prompts, new=6, **kw):
    eng = engine_cls(cfg, params, act_dtype=jnp.float32, **{**KW, **kw})
    return eng.submit_and_run([JRequest(rid=i, prompt=p, max_new_tokens=new)
                               for i, p in enumerate(prompts)])


def test_engine_matches_jax(model):
    jcfg, jparams, cfg, params = model
    prompts = _prompts()
    got = _port(DecodeEngine, cfg, params, prompts)
    assert set(got) == set(range(5)) and all(len(v) == 6 for v in got.values())
    assert got == _jax(JDecodeEngine, jcfg, jparams, prompts)


def test_split_engine_matches_jax_and_unsplit(model):
    jcfg, jparams, cfg, params = model
    prompts = _prompts(seed=1)
    got = _port(SplitDecodeEngine, cfg, params, prompts, cut_units=1)
    assert got == _jax(JSplitDecodeEngine, jcfg, jparams, prompts,
                       cut_units=1)
    assert got == _port(DecodeEngine, cfg, params, prompts)


def test_bulk_prefill_isolates_recurrent_slots(model):
    """Multi-slot output == one-request-at-a-time output: bulk prefill
    leaves the other live slots' mamba state untouched (the port of
    tests/test_serve_engine.py's test of the same name)."""
    _, _, cfg, params = model
    prompts = _prompts(3, seed=2)
    solo = {}
    for i, p in enumerate(prompts):
        solo[i] = _port(DecodeEngine, cfg, params, [p], new=4, n_slots=1)[0]
    assert _port(DecodeEngine, cfg, params, prompts, new=4) == solo


def test_bf16_engine_keeps_f32_leaves_and_matches_reference(model):
    jcfg, jparams, cfg, params = model
    eng = DecodeEngine(cfg, params, act_dtype=torch.bfloat16, device="cpu",
                       **KW)
    mamba = eng.params["units"]["0:mamba2"]["mamba"]
    for name in ("conv_w", "dt_bias", "a_log"):
        assert name in F32_LEAVES and mamba[name].dtype == torch.float32
        assert torch.equal(mamba[name],
                           params["units"]["0:mamba2"]["mamba"][name])
    assert eng.params["final_norm"]["scale"].dtype == torch.float32
    assert mamba["w_in"].dtype == torch.bfloat16
    assert eng.params["shared"]["attn"]["wq"].dtype == torch.bfloat16

    tokens = np.random.default_rng(3).integers(0, 256, (2, 40)).astype(
        np.int32)
    want, _, _ = jlm.forward(
        jcfg, jparams, jnp.asarray(tokens), remat="none",
        ctx=JCtx(cfg=jcfg, mode="prefill", act_dtype=jnp.bfloat16))
    got, _, _ = lm.forward(cfg, eng.params, torch.from_numpy(tokens),
                           ctx=Ctx(cfg=cfg, mode="prefill",
                                   act_dtype=torch.bfloat16))
    err = np.abs(np32(got) - np32(want)).max()
    assert err <= BF16_LOGITS_TOL_OF_MAX * np.abs(np32(want)).max()


def test_loop_prefill_matches_jax_loop(model):
    """The token-by-token prefill, the parity reference, equals the
    reference's own loop token for token. With recurrent state it is not
    bulk prefill: neither package resets a slot's mamba state when the
    slot is refilled, so the second request starts from the first's."""
    jcfg, jparams, cfg, params = model
    prompts = _prompts(3, seed=4)
    got = _port(DecodeEngine, cfg, params, prompts, n_slots=1,
                prefill="loop")
    assert got == _jax(JDecodeEngine, jcfg, jparams, prompts, n_slots=1,
                       prefill="loop")
    assert got[0] == _port(DecodeEngine, cfg, params, prompts[:1],
                           n_slots=1)[0]


@pytest.mark.parametrize("cut", [None, 1])
def test_serve_cli_on_the_cpu(cut):
    argv = ["--arch", ARCH, "--requests", "3", "--new-tokens", "3",
            "--device", "cpu"] + ([] if cut is None else ["--cut", str(cut)])
    out = serve.main(argv)
    assert sorted(out) == [0, 1, 2]
    assert all(len(t) == 3 and all(0 <= x < 256 for x in t)
               for t in out.values())


def test_split_engine_rejects_bad_cut(model):
    _, _, cfg, params = model
    for cut in (0, 2):
        with pytest.raises(ValueError, match="cut_units"):
            SplitDecodeEngine(cfg, params, cut_units=cut, device="cpu")
