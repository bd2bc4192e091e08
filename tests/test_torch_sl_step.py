"""The port's SL step, pass engine, train state and optimizers against
the JAX reference, on the reference's weights and the same NumPy
batches, at a small size (32 px, batch 2). Tolerances: loss, grads and
params after a pass within 5e-4 (the reference's gradient tolerance);
optimizer updates within 1e-6; boundary payloads exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import jax_tree_to_numpy, one_torch_thread
from repro.core import sl_step as jsl
from repro.core.train_state import SLTrainState as JState
from repro.train import optimizer as jopt
from repro_torch.core import sl_step
from repro_torch.core.train_state import SLTrainState
from repro_torch.data.synthetic import ImageryShards
from repro_torch.models.param import from_jax_params, to_jax_params
from repro_torch.train import optimizer

IMG = 32
TOL = 5e-4
SHARDS = ImageryShards(img=IMG, batch=2, n_shards=4)


def _adapters(model):
    return (getattr(jsl, f"{model}_adapter")(img=IMG),
            getattr(sl_step, f"{model}_adapter")(img=IMG))


def _ref_params(jadapter, seed=0):
    """The reference's initial (params_a, params_b) as numpy trees."""
    return [jax_tree_to_numpy(p) for p in jadapter.init(jax.random.key(seed))]


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got_tree, want_tree, tol):
    got = jax.tree.leaves(to_jax_params(got_tree))
    want = jax.tree.leaves(jax_tree_to_numpy(want_tree))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("model", ["autoencoder", "resnet18"])
def test_one_sl_step_matches_reference(model, quantize):
    ja, ta = _adapters(model)
    pa, pb = _ref_params(ja)
    batch = SHARDS.batch_at(1, 0)
    want = jsl.make_sl_step(ja, quantize_boundary=quantize)(
        _jax(pa), _jax(pb), _jax(batch))
    got = sl_step.make_sl_step(ta, quantize_boundary=quantize)(
        from_jax_params(pa), from_jax_params(pb), batch)
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=TOL,
                               atol=TOL)
    _close(got.grads_a, want.grads_a, TOL)
    _close(got.grads_b, want.grads_b, TOL)
    assert got.dtx_bits_down == got.dtx_bits_up == want.dtx_bits_down


@pytest.mark.parametrize("model,quantize,opt", [
    ("autoencoder", False, "adamw"), ("resnet18", True, "sgd")])
def test_sl_pass_matches_reference(model, quantize, opt):
    ja, ta = _adapters(model)
    pa, pb = _ref_params(ja)
    batches = [SHARDS.batch_at(2, i) for i in range(3)]
    jo = jopt.resolve_optimizer(opt, lr=0.05)
    to = optimizer.resolve_optimizer(opt, lr=0.05)
    want = jsl.make_sl_pass(ja, quantize_boundary=quantize, optimizer=jo)(
        JState.create(_jax(pa), _jax(pb), jo), [_jax(b) for b in batches])
    state = SLTrainState.create(from_jax_params(pa), from_jax_params(pb), to)
    got = sl_step.make_sl_pass(ta, quantize_boundary=quantize,
                               optimizer=to)(state, batches)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses),
                               rtol=TOL, atol=TOL)
    _close(got.params_a, want.params_a, TOL)
    _close(got.params_b, want.params_b, TOL)
    assert int(got.state.step) == int(want.state.step) == 3
    assert got.n_steps == want.n_steps == 3
    assert got.dtx_bits_down == want.dtx_bits_down
    # the input state was updated in place: it is consumed
    assert state.consumed and not got.state.consumed
    with pytest.raises(ValueError, match="consumed"):
        sl_step.make_sl_pass(ta, optimizer=to)(state, batches[:1])


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("model", ["autoencoder", "resnet18"])
def test_boundary_bits_match_reference(model, quantize):
    ja, ta = _adapters(model)
    batches = [SHARDS.batch_at(0, 0),
               ImageryShards(img=IMG, batch=3).batch_at(0, 0)]
    want = [jsl.boundary_bits(ja, _jax(b), quantize) for b in batches]
    assert [sl_step.boundary_bits(ta, b, quantize) for b in batches] == want
    np.testing.assert_array_equal(
        sl_step.ring_boundary_bits(ta, batches, quantize),
        jsl.ring_boundary_bits(ja, [_jax(b) for b in batches], quantize))


def test_full_width_boundary_is_the_papers_l2_payload():
    # ResNet-18 at 224 px cut l2, batch 8: z is (8, 28, 28, 128); 8 bits
    # per value with int8, a quarter of Table II's l2 D_tx at f32
    ta = sl_step.resnet18_adapter(cut=5, img=224)
    batch = ImageryShards(img=224, batch=8).batch_at(0, 0)
    bits = sl_step.make_boundary_meter(ta, quantize_boundary=True)(batch)
    assert bits // 8 == 802_816
    assert 4 * bits // 8 == ta.costs().dtx_bits == 3_211_264


def test_apply_updates_where_false_is_an_exact_noop():
    ja, ta = _adapters("autoencoder")
    pa, pb = _ref_params(ja)
    opt = optimizer.adamw(lr=0.1, warmup_steps=1)
    state = SLTrainState.create(from_jax_params(pa), from_jax_params(pb), opt)
    res = sl_step.make_sl_step(ta)(state.params_a, state.params_b,
                                   SHARDS.batch_at(0, 0))
    before = [to_jax_params(t) for t in (state.params_a, state.params_b,
                                         state.opt_a.mu, state.opt_b.nu)]
    same = state.apply_updates(res.grads_a, res.grads_b, opt, where=False)
    assert same is state and not state.consumed
    after = [to_jax_params(t) for t in (same.params_a, same.params_b,
                                        same.opt_a.mu, same.opt_b.nu)]
    for a, b in zip(jax.tree.leaves(before), jax.tree.leaves(after)):
        np.testing.assert_array_equal(a, b)
    assert int(same.step) == 0 and int(same.opt_a.step) == 0
    # where=True (and None) step once and consume the old state
    new = state.apply_updates(res.grads_a, res.grads_b, opt, where=True)
    assert int(new.step) == 1 and state.consumed
    with pytest.raises(ValueError, match="consumed"):
        state.replace(step=new.step)


def test_pass_step_updates_and_consumes_state():
    _, ta = _adapters("autoencoder")
    opt = optimizer.sgd()
    state = SLTrainState.create(*ta.init(torch.Generator().manual_seed(0)),
                                opt)
    step = sl_step.make_pass_step(ta, opt)
    new, loss = step(state, SHARDS.batch_at(0, 0))
    assert bool(torch.isfinite(loss)) and int(new.step) == 1
    assert state.consumed and not new.consumed
    with pytest.raises(ValueError, match="consumed"):
        step(state, SHARDS.batch_at(0, 0))


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_optimizer_updates_match_reference(name):
    rng = np.random.default_rng(3)
    params = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
              "b": rng.standard_normal(5).astype(np.float32)}
    kw = dict(lr=0.05) if name == "sgd" else dict(lr=0.05, warmup_steps=2)
    jo = getattr(jopt, name)(**kw)
    to = getattr(optimizer, name)(**kw)
    jp, tp = _jax(params), from_jax_params(params)
    js, ts = jo.init(jp), to.init(tp)
    for k in range(4):
        g = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32) * 2},
             "b": rng.standard_normal(5).astype(np.float32)}
        jp, js, jm = jo.update(_jax(g), js, jp)
        tp, ts, tm = to.update(from_jax_params(g), ts, tp)
        _close(tp, jp, 1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(ts.step) == int(js.step) == 4


def test_lr_schedule_and_clip_match_reference():
    cfg = jopt.AdamWConfig(lr=0.1, warmup_steps=10, total_steps=100)
    tcfg = optimizer.AdamWConfig(lr=0.1, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 10, 11, 50, 100, 150):
        np.testing.assert_allclose(float(optimizer.lr_at(tcfg, step)),
                                   float(jopt.lr_at(cfg, step)), rtol=1e-6)
    g = {"x": np.full((4,), 3.0, np.float32), "y": np.ones(2, np.float32)}
    got, gn = optimizer.clip_by_global_norm(from_jax_params(g), 1.0)
    want, jgn = jopt.clip_by_global_norm(_jax(g), 1.0)
    np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
    _close(got, want, 1e-6)


def test_sl_pass_takes_the_references_legacy_kwargs():
    """``make_sl_pass(ad, lr=, grad_clip=, donate=, bucket=)`` as the
    reference takes it (tests/test_batched_engine.py calls
    ``make_sl_pass(ad, lr=1e-2)``): lr and grad_clip build the SGD, donate
    and bucket change nothing. Equal, bit for bit, to a pass built with
    the same SGD as ``optimizer=``; and ``SplitAdapter.costs(act_bits=32)``
    is the reference's call."""
    ja, ta = _adapters("autoencoder")
    batches = [SHARDS.batch_at(1, i) for i in range(2)]
    opt = optimizer.sgd(lr=1e-2, grad_clip=0.5)
    runs = []
    for make in (lambda: sl_step.make_sl_pass(ta, lr=1e-2, grad_clip=0.5,
                                              donate=False, bucket=False),
                 lambda: sl_step.make_sl_pass(ta, optimizer=opt)):
        state = SLTrainState.create(*ta.init(torch.Generator().manual_seed(0)),
                                    opt)
        with one_torch_thread():
            runs.append(make()(state, batches))
    assert torch.equal(runs[0].losses, runs[1].losses)
    for a, b in zip(jax.tree.leaves(to_jax_params(runs[0].params_a)),
                    jax.tree.leaves(to_jax_params(runs[1].params_a))):
        np.testing.assert_array_equal(a, b)
    assert ta.costs(act_bits=32) == ta.costs()
    assert dataclasses.astuple(ta.costs(act_bits=8)) == \
        dataclasses.astuple(ja.costs(act_bits=8))
