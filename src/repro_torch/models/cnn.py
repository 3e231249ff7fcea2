"""Small ConvNet, the paper's benchmark family at container scale (port of
``repro/models/cnn.py``). It is the Fig. 2 subject with the GaussianBlobs
task. :func:`cnn_loss` is its training loss (the gradient is autograd's);
the training loop around it stays with the examples and benches (ROADMAP
Queue 1 item 15).

Conv kernels stay in the reference's HWIO layout ``[kh, kw, cin, cout]``:
that is the tensor the sweep injects into (its element index runs over
``reshape(-1, cout)``). Activations are NHWC. Each convolution is written
as explicit ``"SAME"`` padding (``F.pad``; XLA pads 0 before and 1 after
for stride 2, a 3x3 kernel and an even input) plus one matmul of the
strided patches, so every output is a plain sum of products on every
device: no convolution algorithm is chosen for us, and a corrupted inf or
NaN weight reaches only the outputs that read it, as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.common import dense_init


def init_cnn(generator: torch.Generator | None = None, n_classes: int = 10,
             channels: int = 3, width: int = 32, device=None) -> dict:
    """Truncated-normal fan-in init of ``{conv1, conv2, dense, head}`` from
    an explicit generator, on ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    kw = dict(generator=generator, device=device)
    return {
        "conv1": dense_init((3, 3, channels, width), **kw),
        "conv2": dense_init((3, 3, width, 2 * width), **kw),
        "dense": dense_init((2 * width * 16, 4 * width), **kw),
        "head": dense_init((4 * width, n_classes), **kw),
    }


def _same_pads(size: int, k: int, stride: int):
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + k - size, 0)
    return out, total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC x (*) HWIO w with XLA's "SAME" padding."""
    kh, kw, cin, cout = w.shape
    b, h, wd, _ = x.shape
    oh, top, bottom = _same_pads(h, kh, stride)
    ow, left, right = _same_pads(wd, kw, stride)
    xp = F.pad(x, (0, 0, left, right, top, bottom))
    patches = [xp[:, i:i + stride * (oh - 1) + 1:stride,
                  j:j + stride * (ow - 1) + 1:stride, :]
               for i in range(kh) for j in range(kw)]
    cols = torch.stack(patches, dim=3).reshape(b, oh, ow, kh * kw * cin)
    return cols @ w.reshape(kh * kw * cin, cout)


def apply_cnn(params, x: torch.Tensor) -> torch.Tensor:
    """x [B, 16, 16, C] -> logits [B, n_classes]."""
    h = torch.relu(_conv(x, params["conv1"], stride=2))     # [B, 8, 8, w]
    h = torch.relu(_conv(h, params["conv2"], stride=2))     # [B, 4, 4, 2w]
    h = h.reshape(h.shape[0], -1)
    h = torch.relu(h @ params["dense"])
    return h @ params["head"]


def cnn_loss(params, x: torch.Tensor, y: torch.Tensor):
    """(mean negative log-likelihood, accuracy) of labels ``y`` [B]."""
    logits = apply_cnn(params, x)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, y[:, None].to(torch.int64))[:, 0]
    acc = (logits.argmax(-1) == y).to(torch.float32).mean()
    return nll.mean(), acc


def accuracy(params, x: torch.Tensor, y: torch.Tensor) -> float:
    logits = apply_cnn(params, x)
    return float((logits.argmax(-1) == y).to(torch.float32).mean())
