"""The port's LM train step against the reference's arithmetic on the CPU
(``lm.loss`` + ``compression.compress`` + ``adamw_update``, composed by
hand: the reference's ``make_train_step`` needs its mesh helpers), over
two steps for every compression scheme; ``launch.train --smoke --device
cpu`` resuming from a checkpoint; and the unsplit vision losses that the
SL step is held to."""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import jax_tree_to_numpy, np32, one_torch_thread
from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models import vision as jvision
from repro.models.layers import Ctx as JCtx
from repro.train import compression as jcompression
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import adamw_init as jadamw_init
from repro.train.optimizer import adamw_update as jadamw_update
from repro_torch import configs
from repro_torch.launch import train as launch_train
from repro_torch.models import vision
from repro_torch.models.param import from_jax_params
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.step import (TrainConfig, TrainState, make_decode_step,
                                    make_prefill_step, make_train_step)
from repro_torch.utils.treeutil import tree_flatten_with_names

GRAD = dict(atol=5e-4, rtol=5e-4)


def _close(got, want, **tol):
    g = dict(tree_flatten_with_names(got))
    w = dict(tree_flatten_with_names(from_jax_params(jax_tree_to_numpy(want))))
    assert g.keys() == w.keys()
    for name in g:
        np.testing.assert_allclose(np32(g[name]), np32(w[name]),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("scheme", ["none", "int8", "topk"])
def test_train_step_vs_reference_two_steps(scheme):
    jcfg, cfg = (jconfigs.get_smoke("smollm_360m"),
                 configs.get_smoke("smollm_360m"))
    jparams = jlm.init(jcfg, jax.random.key(0))
    acfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jtc = JAdamWConfig(**acfg)
    tcfg = TrainConfig(adamw=AdamWConfig(**acfg), remat="full",
                       compression=scheme, topk_ratio=0.25,
                       act_dtype=torch.float32)
    jctx = JCtx(cfg=jcfg, mesh=None, act_dtype=jnp.float32)

    def jstep(params, opt, ef, batch):
        (lv, m), grads = jax.value_and_grad(
            lambda p: jlm.loss(jcfg, p, batch["tokens"], batch["labels"],
                               ctx=jctx, remat="full"), has_aux=True)(params)
        if scheme != "none":
            grads, efs, _ = jcompression.compress(
                grads, jcompression.ErrorFeedbackState(ef), scheme=scheme,
                topk_ratio=0.25)
            ef = efs.residual
        params, opt, om = jadamw_update(jtc, grads, opt, params)
        return params, opt, ef, lv, om

    step, shardings, batch_sh, _ = make_train_step(cfg, tcfg=tcfg,
                                                   device="cpu")
    assert shardings is None and batch_sh is None
    params = from_jax_params(jax_tree_to_numpy(jparams))
    ef0 = (jcompression.ef_init(jparams).residual if scheme != "none"
           else None)
    state = TrainState(params, adamw_init(params),
                       None if ef0 is None else
                       from_jax_params(jax_tree_to_numpy(ef0)))
    jstate = (jparams, jadamw_init(jparams), ef0)
    rng = np.random.default_rng(1)
    with one_torch_thread():
        for _ in range(2):
            toks = rng.integers(0, cfg.vocab, (2, 13)).astype(np.int32)
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            state, metrics = step(state, batch)
            *jstate, jl, jom = jstep(*jstate, {k: jnp.asarray(v)
                                               for k, v in batch.items()})
            np.testing.assert_allclose(float(metrics["loss"]), float(jl),
                                       rtol=1e-5)
            np.testing.assert_allclose(float(metrics["grad_norm"]),
                                       float(jom["grad_norm"]), rtol=5e-4)
            np.testing.assert_allclose(float(metrics["lr"]), float(jom["lr"]),
                                       rtol=1e-6)
            assert {"ce", "aux", "ntok", "loss", "grad_norm", "lr"} <= \
                set(metrics)
            if scheme != "none":
                assert "compress_payload_bits" in metrics
    # AdamW divides by sqrt(v) + 1e-8: where a gradient is near that eps,
    # the f32 rounding of the two packages moves its update by up to a
    # tenth of lr (1e-3); every update is held to that
    _close(state.params, jstate[0], atol=1e-4, rtol=1e-5)
    _close(state.opt.mu, jstate[1].mu, **GRAD)
    if scheme != "none":
        _close(state.ef, jstate[2], **GRAD)


def test_serving_steps_wrap_forward_and_decode():
    cfg = configs.get_smoke("smollm_360m")
    from repro_torch.models import lm
    params = lm.init(cfg, torch.Generator().manual_seed(0))
    prefill, _ = make_prefill_step(cfg, act_dtype=torch.float32)
    tokens = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    last, caches = prefill(params, {"tokens": tokens})
    assert last.shape == (1, 1, cfg.vocab)
    serve_step, _, _, cache = make_decode_step(
        cfg, batch=1, s_max=8, act_dtype=torch.float32, device="cpu")
    cache = lm.cache_from_prefill(cfg, caches, 8, torch.float32)
    logits, _ = serve_step(params, cache, torch.tensor([[5]]),
                           torch.tensor([4]))
    assert logits.shape == (1, 1, cfg.vocab)
    assert bool(torch.isfinite(logits).all())


def test_launch_train_resumes_to_the_uninterrupted_losses(tmp_path, capsys):
    argv = ["--smoke", "--device", "cpu", "--steps", "6", "--batch", "2",
            "--seq", "16", "--ckpt-every", "3", "--log-every", "3"]
    a, b = tmp_path / "a", tmp_path / "b"
    with one_torch_thread():
        whole = launch_train.main(argv + ["--ckpt-dir", str(a)])
        # an interrupted run: only the step-3 checkpoint survived
        shutil.copytree(a / "step_3", b / "step_3")
        resumed = launch_train.main(argv + ["--ckpt-dir", str(b)])
    out = capsys.readouterr().out
    assert len(whole) == 6 and len(resumed) == 3
    assert resumed == whole[3:]
    assert "restored checkpoint step 3 (resuming at 3)" in out
    assert f"final loss {whole[-1]:.4f} (first {whole[0]:.4f})" in out
    assert whole[-1] < whole[0]


@pytest.mark.parametrize("cut", [None, 5])
def test_vision_losses_vs_reference(cut):
    rng = np.random.default_rng(3)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    labels = np.array([1, 7], np.int32)
    jae = jvision.ae_abstract_params(8, 3)
    from repro.models.param import init_params as jinit
    jp = jinit(jae, jax.random.key(0))
    got = vision.ae_loss(from_jax_params(jax_tree_to_numpy(jp)),
                         torch.from_numpy(images), cut=cut)
    want = jax.jit(jvision.ae_loss, static_argnames="cut")(
        jp, jnp.asarray(images), cut=cut)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    jr = jinit(jvision.resnet18_abstract_params(10), jax.random.key(1))
    with one_torch_thread():
        got = vision.resnet18_loss(from_jax_params(jax_tree_to_numpy(jr)),
                                   torch.from_numpy(images[:, :16, :16]),
                                   torch.from_numpy(labels), cut=cut)
    want = jax.jit(jvision.resnet18_loss, static_argnames="cut")(
        jr, jnp.asarray(images[:, :16, :16]), jnp.asarray(labels), cut=cut)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
