"""The paper's own models in PyTorch: conv autoencoder (Fig. 3 top) and
ResNet-18 (Fig. 3 bottom / Table II), the port of ``repro/models/vision.py``.

Both are *sequential cuttable stages* matching core/splitting.py's
LayerCost lists, so the SL constellation scheduler can execute segment
[0, l) on the "satellite" and [l, L) on the "ground". BatchNorm is
replaced by GroupNorm(8), as in the reference.

Layouts are the reference's at the public functions: activations NHWC,
conv weights HWIO, so parameter trees convert leaf for leaf
(:func:`repro_torch.models.param.from_jax_params`) and the boundary
``z.reshape(-1, C)`` has one row per pixel. Inside a range the stages
run in NCHW, entered through a permuted view of the NHWC input (no
copy), and the NHWC result is a permuted view of the last stage's
output. On the CPU GroupNorm keeps channels-last strides, so that view
is contiguous; on CUDA ``F.group_norm`` returns NCHW-contiguous tensors,
so a boundary cut after a GroupNorm is an NHWC view of NCHW memory
there. The quantizer kernel reads such a boundary as it lies, a thread
per pixel, and writes its result in the same strides (no copy). XLA's
"SAME" padding is uneven for stride 2 on even
inputs (e.g. (2, 3) for the 7x7 stem at 224), so it is applied
explicitly with ``F.pad``; the transposed convs reproduce
``jax.lax.conv_transpose`` (no kernel flip) with ``conv_transpose2d``
on the flipped kernel, cropped to ``in x stride``.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from repro_torch.models.param import ParamSpec


def _conv_spec(cin, cout, k):
    return {"w": ParamSpec((k, k, cin, cout), (None, None, None, "mlp")),
            "b": ParamSpec((cout,), ("mlp",), "zeros")}


def _gn_spec(c):
    return {"scale": ParamSpec((c,), ("mlp",), "ones"),
            "bias": ParamSpec((c,), ("mlp",), "zeros")}


def _same_pads(n: int, k: int, s: int):
    """XLA's "SAME" (low, high) padding of one spatial dim."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad2d(x, k: int, s: int, value: float = 0.0):
    ph = _same_pads(x.shape[2], k, s)
    pw = _same_pads(x.shape[3], k, s)
    if ph == (0, 0) and pw == (0, 0):
        return x
    return F.pad(x, (*pw, *ph), value=value)


def _conv(p, x, stride=1, transpose=False):
    """x: NCHW. "SAME" conv (or transposed conv) with an HWIO kernel."""
    w = p["w"].to(x.dtype)
    k = w.shape[0]
    if transpose:
        # conv_transpose(SAME) = a correlation of the stride-dilated input
        # padded (pad_a, pad_b); conv_transpose2d correlates with the
        # flipped kernel from offset k-1, so shift by k-1-pad_a and crop.
        pad_len = k + stride - 2
        pad_a = k - 1 if stride > k - 1 else -(-pad_len // 2)
        off = k - 1 - pad_a
        H, W = x.shape[2] * stride, x.shape[3] * stride
        y = F.conv_transpose2d(x, w.permute(2, 3, 0, 1).flip(2, 3),
                               stride=stride)
        y = y[:, :, off:off + H, off:off + W]
    else:
        y = F.conv2d(_pad2d(x, k, stride), w.permute(3, 2, 0, 1),
                     stride=stride)
    return y + p["b"].to(x.dtype).reshape(1, -1, 1, 1)


def _groups(C: int, groups: int = 8) -> int:
    g = min(groups, C)
    while C % g:
        g -= 1
    return g


def _gn(p, x, eps=1e-5):
    """GroupNorm over contiguous channel blocks, f32 statistics (biased
    variance), affine in f32, output in x's dtype."""
    C = x.shape[1]
    y = F.group_norm(x.float(), _groups(C), p["scale"].float(),
                     p["bias"].float(), eps)
    return y.to(x.dtype)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1) if x.dim() == 4 else x


# ==========================================================================
# Autoencoder: 224x224x3 -> 7x7xlatent -> 224x224x3 (5 stride-2 stages).
# ==========================================================================

def ae_abstract_params(base: int = 16, latent_ch: int = 3) -> Dict:
    chans = [3, base, base * 2, base * 4, base * 8, latent_ch]
    dchans = [latent_ch, base * 8, base * 4, base * 2, base, 3]
    tree: Dict[str, Any] = {}
    for i in range(5):
        tree[f"enc{i}"] = {"conv": _conv_spec(chans[i], chans[i + 1], 3)}
        if i != 4:      # the latent (the transmitted code) is not normalized
            tree[f"enc{i}"]["gn"] = _gn_spec(chans[i + 1])
    for i in range(5):
        tree[f"dec{i}"] = {"conv": _conv_spec(dchans[i], dchans[i + 1], 3)}
        if i != 4:      # neither is the reconstructed output
            tree[f"dec{i}"]["gn"] = _gn_spec(dchans[i + 1])
    return tree


def ae_stage_names() -> List[str]:
    return [f"enc{i}" for i in range(5)] + [f"dec{i}" for i in range(5)]


def ae_apply_range(params, x, lo: int, hi: int):
    """Apply stages [lo, hi) of the 10-stage autoencoder; x NHWC."""
    names = ae_stage_names()
    x = _nchw(x)
    for idx in range(lo, hi):
        name = names[idx]
        p = params[name]
        x = _conv(p["conv"], x, stride=2, transpose=name.startswith("dec"))
        if "gn" in p:
            x = F.silu(_gn(p["gn"], x).float()).to(x.dtype)
    return _nhwc(x)


def ae_loss(params, images, *, cut=None):
    """MSE reconstruction; ``cut`` optionally runs the two segments with
    an explicit boundary (matching the SL execution graph)."""
    if cut is None:
        recon = ae_apply_range(params, images, 0, 10)
    else:
        z = ae_apply_range(params, images, 0, cut)
        recon = ae_apply_range(params, z, cut, 10)
    return torch.mean(torch.square(recon.float() - images.float()))


# ==========================================================================
# ResNet-18.
# ==========================================================================

def _basic_block_spec(cin, cout):
    s = {"conv1": _conv_spec(cin, cout, 3), "gn1": _gn_spec(cout),
         "conv2": _conv_spec(cout, cout, 3), "gn2": _gn_spec(cout)}
    if cin != cout:
        s["down"] = _conv_spec(cin, cout, 1)
    return s


def resnet18_abstract_params(n_classes: int = 1000) -> Dict:
    return {
        "stem": {"conv": _conv_spec(3, 64, 7), "gn": _gn_spec(64)},
        "s1b1": _basic_block_spec(64, 64), "s1b2": _basic_block_spec(64, 64),
        "s2b1": _basic_block_spec(64, 128), "s2b2": _basic_block_spec(128, 128),
        "s3b1": _basic_block_spec(128, 256), "s3b2": _basic_block_spec(256, 256),
        "s4b1": _basic_block_spec(256, 512), "s4b2": _basic_block_spec(512, 512),
        "head": {"w": ParamSpec((512, n_classes), ("embed", "vocab")),
                 "b": ParamSpec((n_classes,), ("vocab",), "zeros")},
    }


RESNET_STAGES = ["stem", "s1b1", "s1b2", "s2b1", "s2b2", "s3b1", "s3b2",
                 "s4b1", "s4b2", "head"]
_STRIDES = {"s2b1": 2, "s3b1": 2, "s4b1": 2}


def _relu(x):
    return F.relu(x.float()).to(x.dtype)


def _basic_block(p, x, stride):
    h = _conv(p["conv1"], x, stride=stride)
    h = _relu(_gn(p["gn1"], h))
    h = _conv(p["conv2"], h, stride=1)
    h = _gn(p["gn2"], h)
    if "down" in p:
        x = _conv(p["down"], x, stride=stride)
    return _relu(x + h)


def resnet18_apply_range(params, x, lo: int, hi: int):
    """Apply stages [lo, hi) of RESNET_STAGES; x NHWC (or the pooled
    features' logits after the head: (B, n_classes) f32)."""
    x = _nchw(x)
    for idx in range(lo, hi):
        name = RESNET_STAGES[idx]
        p = params[name]
        if name == "stem":
            x = _relu(_gn(p["gn"], _conv(p["conv"], x, stride=2)))
            x = F.max_pool2d(_pad2d(x, 3, 2, value=float("-inf")), 3, 2)
        elif name == "head":
            x = x.mean(dim=(2, 3))
            x = (x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)).float()
        else:
            x = _basic_block(p, x, _STRIDES.get(name, 1))
    return _nhwc(x)


def resnet18_loss(params, images, labels, *, cut=None):
    """Mean softmax cross-entropy of the logits; ``cut`` as in
    :func:`ae_loss`."""
    if cut is None:
        logits = resnet18_apply_range(params, images, 0, 10)
    else:
        z = resnet18_apply_range(params, images, 0, cut)
        logits = resnet18_apply_range(params, z, cut, 10)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[:, None])[:, 0]
    return torch.mean(lse - ll)
