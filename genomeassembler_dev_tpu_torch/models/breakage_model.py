"""Breakage-probability models (mirrors
genomeassembler_dev_tpu/models/breakage_model.py).

  * TableModel — the dense lookup, exactly the reference's semantics;
  * BreakageMLP — a trainable surrogate mapping octamer one-hots to
    log-probabilities, the repository's training path (`cli fit-model`),
    which parallel/sharding.py shards over a (dp, tp) mesh.

The numbers follow the JAX model. Its parameters stay float32 in JAX's
[in, out] layout (w1 b1 w2 b2 w3 b3, so checkpoints carry across without a
transpose). Each of its three dots rounds both operands to bf16 and
accumulates in float32; here that is a float32 product of the two
bf16-rounded operands, each product exact, with float32 sums (TF32 off).
JAX's backward pass rounds both transposed dots' results (the input and the
weight gradient) to bf16 before widening them again; `bf16_dot` does the
same. GELU is the tanh form, jax.nn.gelu's default.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from genomeassembler_dev_tpu_torch.core.querytable import QueryTable

PARAM_NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")


@dataclass(frozen=True)
class TableModel:
    """The reference's probability source: dense code-indexed lookup."""

    table: QueryTable

    def log_prob(self, k: int, codes: torch.Tensor) -> torch.Tensor:
        return torch.log(self.table.probs[k].to(torch.float32))[codes.long()]


def one_hot_octamer(codes: torch.Tensor, k: int = 8) -> torch.Tensor:
    """[N] integer k-mer codes -> [N, 4k] position-wise one-hot features,
    the most significant digit first."""
    shifts = 2 * torch.arange(k - 1, -1, -1, device=codes.device)
    digits = (codes.long()[:, None] >> shifts[None, :]) & 3  # [N, k]
    return F.one_hot(digits, 4).to(torch.float32).reshape(codes.shape[0], 4 * k)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 and widened back to float32."""
    return x.to(torch.bfloat16).to(torch.float32)


class _BF16Dot(torch.autograd.Function):
    """x [N, in] @ w [in, out] as JAX's bf16 dot with float32 accumulation.
    The backward pass rounds grad_x and (unless round_grad_w is False, for
    a gradient still to be summed over data-parallel ranks) grad_w to bf16,
    as JAX's transposed dots do."""

    @staticmethod
    def forward(ctx, x, w, round_grad_w):
        xb, wb = round_bf16(x), round_bf16(w)
        ctx.save_for_backward(xb, wb)
        ctx.round_grad_w = round_grad_w
        return xb @ wb

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        grad_x = round_bf16(g @ wb.T) if ctx.needs_input_grad[0] else None
        grad_w = xb.T @ g
        return grad_x, round_bf16(grad_w) if ctx.round_grad_w else grad_w, None


def bf16_dot(x: torch.Tensor, w: torch.Tensor, round_grad_w: bool = True) -> torch.Tensor:
    torch.backends.cuda.matmul.allow_tf32 = False
    return _BF16Dot.apply(x, w, round_grad_w)


class BreakageMLP(nn.Module):
    """[N, 4k] features -> [N] log-probability: two GELU layers of `hidden`
    units and a linear read-out, parameters in JAX's [in, out] layout."""

    def __init__(self, d_in: int, hidden: int, device=None):
        super().__init__()
        shapes = {"w1": (d_in, hidden), "b1": (hidden,), "w2": (hidden, hidden),
                  "b2": (hidden,), "w3": (hidden, 1), "b3": (1,)}
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.zeros(shape, dtype=torch.float32, device=device)))

    # The layers one by one. Each dot rounds its input to bf16, so two
    # frameworks, or two devices, whose float32 activations differ in the
    # last bits may round a few of them to neighbouring bf16 values; checks
    # compare each layer on the same input.
    def layer1(self, feats: torch.Tensor) -> torch.Tensor:
        return F.gelu(bf16_dot(feats, self.w1) + self.b1, approximate="tanh")

    def layer2(self, h1: torch.Tensor) -> torch.Tensor:
        return F.gelu(bf16_dot(h1, self.w2) + self.b2, approximate="tanh")

    def readout(self, h2: torch.Tensor) -> torch.Tensor:
        return (bf16_dot(h2, self.w3) + self.b3)[:, 0]

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return self.readout(self.layer2(self.layer1(feats)))


def params_from_numpy(arrays: dict, device="cuda") -> BreakageMLP:
    """A model holding the given float32 arrays (e.g. the JAX package's
    parameters as numpy arrays, or one tp shard of them), shapes and layout
    unchanged."""
    w1 = np.asarray(arrays["w1"])
    model = BreakageMLP(w1.shape[0], w1.shape[1], device)
    for name in PARAM_NAMES:
        value = torch.tensor(np.asarray(arrays[name], np.float32), device=device)
        setattr(model, name, nn.Parameter(value))
    return model


def params_to_numpy(model: BreakageMLP) -> dict[str, np.ndarray]:
    return {name: getattr(model, name).detach().cpu().numpy() for name in PARAM_NAMES}


def init_params(generator: torch.Generator, k: int = 8, hidden: int = 256,
                device="cuda") -> BreakageMLP:
    """He-normal weights (scales sqrt(2/d_in), sqrt(2/hidden)), zero biases,
    drawn from `generator`, which must live on `device`."""
    d_in = 4 * k
    model = BreakageMLP(d_in, hidden, device)
    with torch.no_grad():
        for name, scale in (("w1", (2.0 / d_in) ** 0.5), ("w2", (2.0 / hidden) ** 0.5),
                            ("w3", (2.0 / hidden) ** 0.5)):
            w = getattr(model, name)
            w.copy_(torch.randn(w.shape, generator=generator, device=w.device) * scale)
    return model


def forward(params: BreakageMLP, feats: torch.Tensor) -> torch.Tensor:
    """[N, 4k] features -> [N] predicted log-probability."""
    return params(feats)


def loss_fn(params: BreakageMLP, codes: torch.Tensor, target_logp: torch.Tensor) -> torch.Tensor:
    pred = forward(params, one_hot_octamer(codes, params.w1.shape[0] // 4))
    return torch.mean((pred - target_logp) ** 2)


def adam(params: BreakageMLP, lr: float) -> torch.optim.Adam:
    """optax.adam(lr): eps outside the square root, bias-corrected moments."""
    return torch.optim.Adam(params.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def make_train_step(optimizer: torch.optim.Optimizer):
    """Returns train_step(params, codes, target_logp) -> loss (a 0-d tensor
    on the device, not read back), one optimizer step over the parameters
    that `optimizer` holds."""

    def train_step(params: BreakageMLP, codes: torch.Tensor,
                   target_logp: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, codes, target_logp)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def save_params(path: str, params: BreakageMLP) -> None:
    """Checkpoint as npz with the JAX package's keys and shapes."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **params_to_numpy(params))


def load_params(path: str, device="cuda") -> BreakageMLP:
    with np.load(path) as d:
        return params_from_numpy({k: d[k] for k in d.files}, device)


def fit_to_table(
    table: QueryTable,
    k: int = 8,
    steps: int = 200,
    batch: int = 4096,
    hidden: int = 256,
    lr: float = 1e-3,
    seed: int = 0,
    device=None,
):
    """Distil the k-mer table into the MLP on `device` (default: the
    table's). Returns (params, losses [steps] numpy). Codes are drawn from
    one generator seeded with `seed`, after the initial weights."""
    device = torch.device(device) if device is not None else table.probs[k].device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = init_params(gen, k, hidden, device)
    step = make_train_step(adam(params, lr))
    logp = torch.log(table.probs[k].to(device=device, dtype=torch.float32))
    losses = torch.empty(steps, dtype=torch.float32, device=device)
    for i in range(steps):
        codes = torch.randint(0, logp.shape[0], (batch,), generator=gen, device=device)
        losses[i] = step(params, codes, logp[codes])
    return params, losses.cpu().numpy()
