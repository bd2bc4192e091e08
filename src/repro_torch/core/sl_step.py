"""The split-learning train step (paper Fig. 1 steps 1-8, on real models):
the port of ``repro/core/sl_step.py``.

One SL step over a batch at the current satellite:

  (1-2) satellite forward on segment A          -> boundary activations z
  (3)   downlink z (optionally int8-quantized)           [D_tx, eq. 8-9]
  (4-5) ground forward+loss+backward on segment B
  (6)   uplink boundary gradient dz (optionally quantized)
  (7)   satellite backward through segment A: ``autograd.grad(z, ...,
        dz)`` takes the place of the reference's ``vjp_a``
  (8)   both sides apply the optimizer; at pass end segment A ships over
        the ISL.

The boundary is NHWC, so the int8 quantizer (``ops.ste_quantize``)
takes one row per pixel with the abs-max over channels, as the
reference does, and every quantized step runs it twice (z down, dz up).
On a CUDA tensor each crossing is one launch of the hand-written kernel,
which reads the boundary in the strides it arrives in (on the card an
NHWC view of NCHW memory) and writes the dequantized result in the same
strides, so segment B receives z, and segment A dz, laid out as the
other side left it. The payload is ``z.numel() * 8`` bits (``* 32``
unquantized).

Pass engine: the reference fuses a pass into one jitted ``lax.scan``
whose step count it pads to a bucket with masked no-op steps, to keep
XLA's compile cache small. PyTorch runs eagerly, so
:func:`make_sl_pass` runs exactly the valid steps, one after another,
and reports the same per-step losses and final state. Parameters and
optimizer state are updated in place (see
:mod:`repro_torch.core.train_state`); the losses stay on the device
until the caller reads them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.energy import SplitCosts
from repro_torch.core.splitting import SplitPlan
from repro_torch.core.train_state import SLTrainState
from repro_torch.kernels import ops
from repro_torch.models.param import init_params, map_tree
from repro_torch.train.optimizer import resolve_optimizer
from repro_torch.utils.treeutil import tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class SplitAdapter:
    """Model-agnostic view of a cut model. ``specs`` holds the ParamSpec
    trees of segment A (satellite) and segment B (ground)."""

    name: str
    specs: Tuple[Dict, Dict]
    forward_a: Callable[[Any, Dict], torch.Tensor]   # (params_a, batch) -> z
    loss_b: Callable[[Any, torch.Tensor, Dict], torch.Tensor]
    plan: SplitPlan
    cut_index: int
    # (generator) -> (params_a, params_b), for a model whose segments share
    # initial weights; None draws both from the merged specs
    init_fn: Optional[Callable[[torch.Generator], Tuple[Any, Any]]] = None

    def init(self, generator: torch.Generator) -> Tuple[Any, Any]:
        """(params_a, params_b) drawn from ``generator`` (on its device),
        leaves in the sorted order of the whole tree (or by ``init_fn``)."""
        if self.init_fn is not None:
            return self.init_fn(generator)
        spec_a, spec_b = self.specs
        p = init_params({**spec_a, **spec_b}, generator)
        return ({k: p[k] for k in spec_a}, {k: p[k] for k in spec_b})

    def costs(self, act_bits: int = 32) -> SplitCosts:
        """The cut's costs; ``act_bits`` is accepted, as the reference's
        signature has it, and ignored there too (the engines measure the
        boundary payload instead)."""
        return self.plan.costs_at(self.cut_index)


@dataclasses.dataclass
class SLStepResult:
    loss: torch.Tensor
    grads_a: Any
    grads_b: Any
    dtx_bits_down: int                  # measured boundary payload (one way)
    dtx_bits_up: int


def _device_of(params) -> torch.device:
    return tree_leaves(params)[0].device


def _as_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The batch's arrays (numpy or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _make_sl_grads(adapter: SplitAdapter, quantize_boundary: bool):
    """The step body shared by make_sl_step and make_pass_step:
    (params_a, params_b, batch) -> (loss, g_a, g_b, payload_bits)."""

    q_bits = 8 if quantize_boundary else 32

    def sl_grads(params_a, params_b, batch):
        pa = map_tree(lambda t: t.detach().requires_grad_(), params_a)
        pb = map_tree(lambda t: t.detach().requires_grad_(), params_b)
        batch = _as_batch(batch, _device_of(params_a))
        with torch.enable_grad():
            # satellite forward; its graph is kept for step (7)
            z = adapter.forward_a(pa, batch)
            z_tx = z.detach()
            if quantize_boundary:
                z_tx = ops.ste_quantize(z_tx)
            z_tx.requires_grad_()

            # ground: loss + backward wrt segment B and wrt the boundary
            loss = adapter.loss_b(pb, z_tx, batch)
            leaves_b = tree_leaves(pb)
            *g_b, g_z = torch.autograd.grad(loss, leaves_b + [z_tx])

            # uplink gradient (quantized the same way on the return path)
            g_z_tx = ops.ste_quantize(g_z) if quantize_boundary else g_z
            g_a = torch.autograd.grad(z, tree_leaves(pa), g_z_tx.to(z.dtype))
        return (loss.detach(), tree_unflatten(params_a, g_a),
                tree_unflatten(params_b, g_b), z.numel() * q_bits)

    return sl_grads


def make_sl_step(adapter: SplitAdapter, *, quantize_boundary: bool = False):
    """Returns sl_step(params_a, params_b, batch) -> SLStepResult (grads
    only; nothing is updated)."""

    grads = _make_sl_grads(adapter, quantize_boundary)

    def run(params_a, params_b, batch) -> SLStepResult:
        loss, g_a, g_b, payload = grads(params_a, params_b, batch)
        return SLStepResult(loss=loss, grads_a=g_a, grads_b=g_b,
                            dtx_bits_down=int(payload),
                            dtx_bits_up=int(payload))

    return run


def _meta(v) -> torch.Tensor:
    """A meta tensor with the shape and dtype of array or tensor ``v``."""
    return torch.empty(tuple(v.shape), dtype=torch.as_tensor(v[:0]).dtype,
                       device="meta")


def boundary_bits(adapter: SplitAdapter, batch,
                  quantize_boundary: bool = False) -> int:
    """Exact one-way boundary payload (bits) for ``batch`` — shape-only:
    segment A runs on the meta device, so measuring costs no FLOPs and
    launches nothing."""
    pa = map_tree(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                        device="meta"), adapter.specs[0])
    with torch.no_grad():
        z = adapter.forward_a(pa, {k: _meta(v) for k, v in batch.items()})
    return z.numel() * (8 if quantize_boundary else 32)


def _batch_shape_key(batch):
    return tuple(sorted((k, tuple(v.shape), str(v.dtype))
                        for k, v in batch.items()))


def make_boundary_meter(adapter: SplitAdapter,
                        quantize_boundary: bool = False):
    """A :func:`boundary_bits` memoized per batch shape (the shared
    payload cache of the pass engine and the constellation scheduler)."""
    cache: Dict[Any, int] = {}

    def measure(batch) -> int:
        key = _batch_shape_key(batch)
        bits = cache.get(key)
        if bits is None:
            bits = boundary_bits(adapter, batch, quantize_boundary)
            cache[key] = bits
        return bits

    return measure


def ring_boundary_bits(adapter: SplitAdapter, batches: Sequence[Dict],
                       quantize_boundary: bool = False) -> np.ndarray:
    """Per-satellite boundary payloads (bits, one way) as ONE array, from
    one representative batch per ring member (shapes may differ)."""
    meter = make_boundary_meter(adapter, quantize_boundary)
    return np.asarray([float(meter(b)) for b in batches], dtype=np.float64)


# --------------------------------------------------------------------------
# The pass engine.
# --------------------------------------------------------------------------

def make_pass_step(adapter: SplitAdapter, optimizer, *,
                   quantize_boundary: bool = False):
    """The masked SL step shared by the host pass engine and the device
    engine: ``pass_step(state, batch, valid=True) -> (new_state, loss)``.

    Runs both grads and the optimizer update on an
    :class:`~repro_torch.core.train_state.SLTrainState` (in place; the
    input state is consumed) and gates it on ``valid``: an invalid step
    leaves params, optimizer state and step counter bit for bit as they
    were and reports a NaN loss. ``valid`` is a host bool
    (:func:`make_sl_pass` passes True) or a 0-d bool tensor decided on
    the device (:mod:`repro_torch.sim.device_sim`, whose reserve skips
    and beyond-allocation steps mask this way); a tensor is never read
    back to the host.
    """
    sl_grads = _make_sl_grads(adapter, quantize_boundary)

    def pass_step(state, batch, valid=True):
        loss, g_a, g_b, _ = sl_grads(state.params_a, state.params_b, batch)
        state = state.apply_updates(g_a, g_b, optimizer, where=valid)
        if isinstance(valid, torch.Tensor):
            loss = torch.where(valid, loss, torch.nan)
        elif not valid:
            loss = torch.full_like(loss, torch.nan)
        return state, loss

    return pass_step


def dedupe_state_buffers(state: SLTrainState) -> SLTrainState:
    """A live state whose leaves share no memory: a leaf that aliases an
    earlier one (e.g. a tied LM embedding shared between segments A and
    B) is copied, since the in-place update would otherwise apply twice
    to one buffer, and the segments diverge after the first update
    anyway. Used by the device engine before it takes a state over."""
    from repro_torch.core.train_state import _leaves, _rebuild

    state._require_live("dedupe_state_buffers")
    seen, copied = set(), []

    def uniq(t):
        if t.numel() and t.data_ptr() in seen:
            copied.append(t)
            return t.clone()
        seen.add(t.data_ptr())
        return t

    fields = [state.params_a, state.params_b, state.opt_a, state.opt_b,
              state.step]
    new = SLTrainState(*_rebuild(fields, iter(
        [uniq(t) for t in _leaves(fields)])))
    if not copied:                 # the leaves are the same tensors
        new._flat = state._flat
    return new


@dataclasses.dataclass
class SLPassResult:
    """One whole pass: k SL steps + optimizer updates, as a state."""

    losses: torch.Tensor                # (k,) per-step training loss
    state: Any                          # SLTrainState after the pass
    n_steps: int
    dtx_bits_down: int                  # boundary payload per step (one way)
    dtx_bits_up: int

    @property
    def params_a(self):
        return self.state.params_a

    @property
    def params_b(self):
        return self.state.params_b


def make_sl_pass(adapter: SplitAdapter, *, quantize_boundary: bool = False,
                 optimizer=None, lr: float = 1e-2, grad_clip: float = 1.0,
                 donate: bool = True, bucket: bool = True):
    """Returns a pass executor running k SL steps:
    ``sl_pass(state, batches) -> SLPassResult``.

    ``optimizer`` is an :class:`~repro_torch.train.optimizer.Optimizer`, a
    registered name (``"sgd"``/``"adamw"``), or None for SGD built from
    ``lr`` and ``grad_clip``, as in the reference. ``batches`` is a list
    of k per-step batch dicts (shapes may vary between steps). The input
    state is consumed (its tensors are updated in place); chain
    ``result.state`` forward.

    ``donate`` and ``bucket`` are the reference's jit options (buffer
    donation, step counts padded to a bucket); eager torch has no
    counterpart, so they are accepted and ignored: the state is always
    updated in place and exactly the given steps run.
    """
    opt = resolve_optimizer(optimizer, lr=lr, grad_clip=grad_clip)
    step = make_pass_step(adapter, opt, quantize_boundary=quantize_boundary)
    measure_payload = make_boundary_meter(adapter, quantize_boundary)

    def run(state, batches: Sequence[Dict]) -> SLPassResult:
        if not isinstance(state, SLTrainState):
            raise TypeError("sl_pass(state, batches) expects an "
                            f"SLTrainState, got {type(state).__name__}")
        state._require_live("pass")
        if not batches:
            raise ValueError("a pass needs at least one batch")
        payload = measure_payload(batches[0])
        losses = []
        for batch in batches:
            state, loss = step(state, batch, True)
            losses.append(loss)
        return SLPassResult(losses=torch.stack(losses), state=state,
                            n_steps=len(batches), dtx_bits_down=payload,
                            dtx_bits_up=payload)

    return run


# --------------------------------------------------------------------------
# Adapters for the paper's models and the LM track.
# --------------------------------------------------------------------------

def _split_specs(spec: Dict, names: Sequence[str], cut: int):
    return ({k: spec[k] for k in names[:cut]},
            {k: spec[k] for k in names[cut:]})


def autoencoder_adapter(cut: int = 5, img: int = 64, base: int = 16,
                        latent_ch: int = 3) -> SplitAdapter:
    """Encoder (satellite) / decoder (ground) — paper §V-A (cut=5)."""
    from repro_torch.core.splitting import autoencoder_plan
    from repro_torch.models import vision

    names = vision.ae_stage_names()

    def fa(pa, batch):
        return vision.ae_apply_range(pa, batch["images"], 0, cut)

    def lb(pb, z, batch):
        recon = vision.ae_apply_range(pb, z, cut, len(names))
        return torch.mean(torch.square(recon.float()
                                       - batch["images"].float()))

    return SplitAdapter(
        "autoencoder",
        _split_specs(vision.ae_abstract_params(base, latent_ch), names, cut),
        fa, lb,
        plan=autoencoder_plan(img=img, base=base, latent_ch=latent_ch),
        cut_index=cut)


def resnet18_adapter(cut: int = 5, img: int = 64,
                     n_classes: int = 10) -> SplitAdapter:
    """ResNet-18 classification, Table II cuts l1/l2/l3 = 3/5/7."""
    from repro_torch.core.splitting import resnet18_plan
    from repro_torch.models import vision

    names = vision.RESNET_STAGES

    def fa(pa, batch):
        return vision.resnet18_apply_range(pa, batch["images"], 0, cut)

    def lb(pb, z, batch):
        logits = vision.resnet18_apply_range(pb, z, cut, len(names))
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, batch["labels"].long()[:, None])[:, 0]
        return torch.mean(lse - ll)

    return SplitAdapter(
        "resnet18",
        _split_specs(vision.resnet18_abstract_params(n_classes), names, cut),
        fa, lb, plan=resnet18_plan(img=img, n_classes=n_classes),
        cut_index=cut)


def lm_adapter(cfg, cut_units: int, seq_len: int) -> SplitAdapter:
    """LM split at a pattern-unit boundary: embed + units[:u] on the
    satellite, units[u:] + final norm + head on the ground, activations
    in f32. With tied embeddings the ground holds the head as its own
    leaf ``head_tied``, initialised to the embedding; Zamba2's shared
    block goes to both segments. As in the reference, both copies start
    equal and then train apart; here each is its own buffer from init
    (the optimizers update in place)."""
    from repro_torch.core.splitting import lm_plan
    from repro_torch.models import lm
    from repro_torch.models.layers import Ctx

    pat_len = len(cfg.pattern_unit())
    cut_blocks = cut_units * pat_len
    ctx = Ctx(cfg=cfg, act_dtype=torch.float32)

    spec = lm.abstract_params(cfg)
    units = lambda n: map_tree(lambda sp: dataclasses.replace(
        sp, shape=(n,) + sp.shape[1:]), spec["units"])
    spec_a = {"embed": spec["embed"], "units": units(cut_units)}
    spec_b = {"units": units(cfg.n_units - cut_units),
              "final_norm": spec["final_norm"]}
    if "head" in spec:
        spec_b["head"] = spec["head"]
    else:
        spec_b["head_tied"] = spec["embed"]
    if "shared" in spec:
        spec_a["shared"] = spec["shared"]
        spec_b["shared"] = spec["shared"]

    def _init(generator):
        p = lm.init(cfg, generator)
        pa = {"embed": p["embed"],
              "units": map_tree(lambda t: t[:cut_units].clone(), p["units"])}
        pb = {"units": map_tree(lambda t: t[cut_units:].clone(), p["units"]),
              "final_norm": p["final_norm"]}
        if "head" in p:
            pb["head"] = p["head"]
        else:
            pb["head_tied"] = p["embed"].clone()
        if "shared" in p:
            pa["shared"] = p["shared"]
            pb["shared"] = map_tree(torch.clone, p["shared"])
        return pa, pb

    def fa(pa, batch):
        return lm.forward_segment(cfg, pa, None, 0, cut_blocks, ctx=ctx,
                                  tokens=batch["tokens"])

    def lb(pb, z, batch):
        pfull = {k: v for k, v in pb.items() if k != "head_tied"}
        if "head_tied" in pb:
            pfull["embed"] = pb["head_tied"]
        logits = lm.forward_segment(cfg, pfull, z, cut_blocks,
                                    lm.n_blocks(cfg), ctx=ctx,
                                    unit_offset=cut_units)
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
        return torch.mean(lse - ll)

    return SplitAdapter(cfg.name, (spec_a, spec_b), fa, lb,
                        plan=lm_plan(cfg, seq_len), cut_index=cut_blocks,
                        init_fn=_init)
