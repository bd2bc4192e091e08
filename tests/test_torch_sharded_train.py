"""The port's train step on a ``(data, model)`` mesh of gloo ranks on the
CPU, against the reference's arithmetic (``lm.loss`` + ``adamw_update``
composed by hand with ``Ctx(mesh=None)``: the reference's own sharded
step raises here, ROADMAP C2) and against the port's one-process step:
two f32 steps of the SmolLM, Llama-3-8B and Granite smoke configs (and
Granite's with an indivisible 131-row vocab) on meshes (2, 1), (1, 2),
(2, 2) and (1, 4) (heads cut, KV heads replicated), Zamba2's and xLSTM's
on (2, 1); ``launch.train --model-parallel 2`` on 2 and 4 ranks, with
checkpoints that resume across mesh shapes; the (1, 1) mesh bit for bit
the one-process step; and a step leaving nothing for the cyclic GC.

The ranks are processes (``tests/_torch_mesh_worker.py``), two groups of
them for the whole file, meeting through files under ``tmp_path`` so no
two test workers share a port; every wait has a timeout."""
import dataclasses
import gc
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_worker as W
from _torch_helpers import jax_tree_to_numpy, np32, one_torch_thread
from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models.layers import Ctx as JCtx
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import adamw_init as jadamw_init
from repro.train.optimizer import adamw_update as jadamw_update
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_host_mesh, process_group
from repro_torch.models import parallel
from repro_torch.models.param import (ShardingRules, from_jax_params,
                                      map_tree, to_jax_params)
from repro_torch.train.step import make_train_step
from repro_torch.utils.treeutil import tree_flatten_with_names, tree_leaves

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300
TOL = dict(atol=5e-4, rtol=5e-4)
REFERENCE = ["smollm_360m", "llama3_8b", "granite_3_2b"]
DENSE = REFERENCE + ["granite_3_2b/131"]
RECURRENT = ["zamba2_1_2b", "xlstm_1_3b"]
CASES = ([((2, 1), a) for a in DENSE + RECURRENT]
         + [(mesh, a) for mesh in ((1, 2), (2, 2), (1, 4)) for a in DENSE])
LAUNCH = "--smoke --device cpu --steps 6 --batch 2 --seq 16 --log-every 3"
# launch.train runs bf16 activations: a model axis sums the row-split
# products' bf16 partials, each rounded at 2^-9 relative, where one
# process rounds their sum once
BF16_LOSS = dict(rtol=2.0 ** -9)


def _spawn(out: Path, groups):
    """Run each group of ``world`` worker ranks over its jobs, all groups
    at once; fail on a rank's error or on the timeout (every rank
    killed). ``groups``: {name: (world, jobs)}."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    logs, procs = {}, {}
    for name, (world, jobs) in groups.items():
        for r in range(world):
            log = logs[name, r] = open(out / f"{name}_rank{r}.log", "w")
            procs[name, r] = subprocess.Popen(
                [sys.executable, str(ROOT / "tests" / "_torch_mesh_worker.py"),
                 str(out), str(r), str(world), f"file://{out}/pg_{name}",
                 *jobs], env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        for p in procs.values():
            p.wait(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        pytest.fail(f"ranks still running after {TIMEOUT_S} s")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs.values():
            f.close()
    for (name, r), p in procs.items():
        assert p.returncode == 0, \
            (out / f"{name}_rank{r}.log").read_text()[-4000:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both groups of ranks, and the one-process launch.train run whose
    step-3 checkpoint the (2, 2) ranks resume from."""
    out = tmp_path_factory.mktemp("mesh")
    with one_torch_thread():
        whole = launch_train.main(
            LAUNCH.split() + ["--ckpt-every", "3", "--ckpt-dir",
                              str(out / "one")])
    (out / "from_one").mkdir()
    shutil.copytree(out / "one" / "step_3", out / "from_one" / "step_3")
    _spawn(out, {
        "two": (2, [f"steps:1:{','.join(DENSE + RECURRENT)}",
                    f"steps:2:{','.join(DENSE)}",
                    f"launch:mp2:{LAUNCH} --model-parallel 2"]),
        "four": (4, [f"steps:2:{','.join(DENSE)}",
                     f"steps:4:{','.join(DENSE)}",
                     f"launch:fresh:{LAUNCH} --model-parallel 2 "
                     f"--ckpt-every 3 --ckpt-dir {out / 'from_22'}",
                     f"launch:resumed:{LAUNCH} --model-parallel 2 "
                     f"--ckpt-every 3 --ckpt-dir {out / 'from_one'}"])})
    return out, whole


def _reference(arch):
    """Two steps of the reference's arithmetic from the port's seeded
    init: [(loss, grad norm, params as port tensors)]."""
    name, _, vocab = arch.partition("/")
    jcfg = jconfigs.get_smoke(name)
    if vocab:
        jcfg = dataclasses.replace(jcfg, vocab=int(vocab))
    cfg = W.smoke_config(arch)
    _, _, _, init = make_train_step(cfg, tcfg=W.train_config(), device="cpu")
    params = jax.tree.map(jnp.asarray, to_jax_params(
        init(torch.Generator().manual_seed(0)).params))
    opt = jadamw_init(params)
    jctx = JCtx(cfg=jcfg, mesh=None, act_dtype=jnp.float32)

    @jax.jit                   # eager, the reference takes ~15 s a config
    def jstep(params, opt, b):
        (lv, _), grads = jax.value_and_grad(
            lambda p: jlm.loss(jcfg, p, b["tokens"], b["labels"], ctx=jctx,
                               remat="full"), has_aux=True)(params)
        params, opt, om = jadamw_update(JAdamWConfig(**W.ADAMW), grads, opt,
                                        params)
        return params, opt, lv, om["grad_norm"]

    out = []
    for batch in W.batches(cfg):
        params, opt, lv, gn = jstep(params, opt, {
            k: jnp.asarray(v) for k, v in batch.items()})
        out.append((float(lv), float(gn),
                    from_jax_params(jax_tree_to_numpy(params))))
    return out


def _one_process(arch):
    cfg = W.smoke_config(arch)
    step, specs, _, init = make_train_step(cfg, tcfg=W.train_config(),
                                           device="cpu")
    assert specs is None
    state, out = init(torch.Generator().manual_seed(0)), []
    for batch in W.batches(cfg):
        state, m = step(state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    map_tree(torch.clone, state.params)))
    return out


@pytest.fixture(scope="module")
def expected():
    """The reference's and the one-process port's steps, per arch."""
    cache = {}

    def get(arch):
        if arch not in cache:
            with one_torch_thread():
                ref = _reference(arch) if arch in REFERENCE else None
                cache[arch] = (ref, _one_process(arch))
        return cache[arch]
    return get


def _close_params(got, want, what):
    got, want = (dict(tree_flatten_with_names(t)) for t in (got, want))
    assert got.keys() == want.keys(), what
    for name in got:
        np.testing.assert_allclose(np32(got[name]), np32(want[name]),
                                   err_msg=f"{what} {name}", **TOL)


@pytest.mark.parametrize("mesh,arch", CASES,
                         ids=[f"{d}x{m}-{a}" for (d, m), a in CASES])
def test_sharded_steps_equal_reference_and_one_process(runs, expected, mesh,
                                                       arch):
    out, _ = runs
    rec = torch.load(W.record_path(out, mesh, arch))
    assert tuple(rec["mesh"]) == mesh
    ref, one = expected(arch)
    for i, got in enumerate(rec["steps"]):
        assert got["collectives"] > 0
        wants = [("one process", one[i])] + \
            ([("reference", ref[i])] if ref is not None else [])
        for what, (loss, gn, params) in wants:
            what = f"{arch} on {mesh}, step {i + 1}, vs {what}"
            np.testing.assert_allclose(got["loss"], loss, rtol=1e-5,
                                       err_msg=what)
            np.testing.assert_allclose(got["grad_norm"], gn, rtol=5e-4,
                                       err_msg=what)
            _close_params(got["params"], params, what)


def test_launch_train_model_parallel_2_gives_the_one_process_losses(runs):
    out, whole = runs
    np.testing.assert_allclose(torch.load(out / "launch_mp2.pt"), whole,
                               **BF16_LOSS)


def test_checkpoints_resume_across_mesh_shapes(runs, capsys):
    """(2, 2) from scratch, saving; (2, 2) resumed from the one-process
    step-3 checkpoint; one process resumed from the (2, 2) step-3
    checkpoint: each gives the uninterrupted one-process losses."""
    out, whole = runs
    np.testing.assert_allclose(torch.load(out / "launch_fresh.pt"), whole,
                               **BF16_LOSS)
    np.testing.assert_allclose(torch.load(out / "launch_resumed.pt"),
                               whole[3:], **BF16_LOSS)
    one, mesh22 = out / "one" / "step_3", out / "from_22" / "step_3"
    assert sorted(os.listdir(mesh22)) == sorted(os.listdir(one))
    resume = out / "to_one"
    shutil.copytree(mesh22, resume / "step_3")
    capsys.readouterr()
    with one_torch_thread():
        resumed = launch_train.main(LAUNCH.split() + ["--ckpt-dir",
                                                      str(resume)])
    assert "restored checkpoint step 3 (resuming at 3)" in \
        capsys.readouterr().out
    np.testing.assert_allclose(resumed, whole[3:], **BF16_LOSS)


@pytest.mark.parametrize("arch", ["smollm_360m", "llama3_8b", "zamba2_1_2b",
                                  "whisper_small"])
def test_one_by_one_mesh_is_the_one_process_step_bit_for_bit(arch):
    """No single-card branch: the (1, 1) mesh runs the sharded step, with
    collectives of one rank, and equals the one-process step exactly.
    Its model axis cuts nothing, so the layers call no collective: the
    loss's sum and token count, one sum a gradient leaf and the norm's."""
    cfg = W.smoke_config(arch)
    tcfg = dataclasses.replace(W.train_config(), act_dtype=torch.bfloat16)
    rng = np.random.default_rng(3)
    with one_torch_thread(), process_group("cpu") as dev:
        mesh = make_host_mesh(1, dev)
        sharded, specs, batch_specs, init = make_train_step(
            cfg, mesh, ShardingRules(), tcfg, device="cpu")
        step, _, _, init1 = make_train_step(cfg, tcfg=tcfg, device="cpu")
        a, b = init(0), init1(0)
        for _ in range(2):
            toks = rng.integers(0, cfg.vocab, (2, 9))
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            if cfg.frontend == "audio":
                batch["enc_frames"] = torch.zeros(
                    (2, cfg.frontend_len, cfg.d_model), dtype=torch.bfloat16)
            parallel.COLLECTIVES.clear()
            a, ma = sharded(a, batch)
            assert parallel.COLLECTIVES == {
                "all_reduce": 2 + len(tree_leaves(a.params)) + 1}
            b, mb = step(b, batch)
            for k in ("loss", "grad_norm", "lr"):
                assert torch.equal(ma[k], mb[k]), k
            for x, y in zip(tree_leaves((a.params, tuple(a.opt))),
                            tree_leaves((b.params, tuple(b.opt)))):
                assert torch.equal(x, y)
        assert batch_specs(batch)["tokens"] == ("data", None)
        assert specs.opt.step == ()


def test_a_train_step_leaves_nothing_for_the_cyclic_gc():
    """ROADMAP C14: a step's tensors (its gradients) were kept in a
    reference cycle until the cyclic GC ran."""
    cfg = W.smoke_config("smollm_360m")
    step, _, _, init = make_train_step(cfg, tcfg=W.train_config(),
                                       device="cpu")
    state = init(0)
    batches = list(W.batches(cfg))
    with one_torch_thread():
        state, _ = step(state, batches[0])
        gc.collect()
        flags = gc.get_debug()
        gc.set_debug(gc.DEBUG_SAVEALL)
        try:
            state, _ = step(state, batches[1])
            gc.collect()
            left = [o for o in gc.garbage if torch.is_tensor(o)]
        finally:
            gc.set_debug(flags)
            gc.garbage.clear()
    assert left == [], [tuple(t.shape) for t in left]
