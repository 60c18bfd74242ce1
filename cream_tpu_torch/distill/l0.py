"""L0 structured pruning by hard-concrete gates (TinyCLIP).

Counterpart of `cream_tpu/distill/l0.py` (TinyCLIP/src/open_clip/
l0module.py:11-368, itself from CoFiPruning): log-alpha parameters per
granularity {hidden, heads, mha, intermediate, ffn}, stretched-concrete
samples in training, deterministic masks at inference, and an
expected-sparsity lagrangian with learned multipliers lambda_1/lambda_2.

The parameters are a dict of fp32 leaf tensors that require grad; the
loga of a ragged tower (a pruned model with per-layer head counts or MLP
widths) are tuples of per-layer rows. Noise comes from an explicit
`torch.Generator`, or from given uniforms (the tests feed the JAX
package's draws). The multipliers ascend the lagrangian: negate their
grads (`negate_lambda_grads`) before the optimizer steps.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import numpy as np
import torch

LIMIT_A, LIMIT_B, EPS = -0.1, 1.1, 1e-6
TEMPERATURE = 2.0 / 3.0
MAGICAL_NUMBER = 0.8

# loga parameter -> the model-facing mask it gives, in draw order
MASK_NAMES = {"hidden_loga": "hidden_z", "heads_loga": "heads_z", "mha_loga": "mha_z",
              "intermediate_loga": "intermediate_z", "ffn_loga": "ffn_z"}


@dataclasses.dataclass(frozen=True)
class L0Config:
    hidden_size: int
    intermediate_size: int
    num_attention_heads: int
    num_hidden_layers: int
    pruning_types: tuple = ("hidden", "heads", "intermediate", "layer")
    # a ragged tower's per-layer head counts / MLP widths: its heads and
    # intermediate loga are then tuples of per-layer rows
    heads_per_layer: tuple | None = None
    intermediate_per_layer: tuple | None = None

    @property
    def params_per_head(self) -> int:
        per_layer = self.hidden_size * self.hidden_size * 4 + self.hidden_size * 4
        return per_layer // self.num_attention_heads

    @property
    def params_per_intermediate_dim(self) -> int:
        per_layer = (self.hidden_size * self.intermediate_size * 2
                     + self.hidden_size + self.intermediate_size)
        return per_layer // self.intermediate_size

    @property
    def total_heads(self) -> int:
        if self.heads_per_layer is not None:
            return sum(self.heads_per_layer)
        return self.num_hidden_layers * self.num_attention_heads

    @property
    def total_intermediate(self) -> int:
        if self.intermediate_per_layer is not None:
            return sum(self.intermediate_per_layer)
        return self.num_hidden_layers * self.intermediate_size

    @property
    def prunable_model_size(self) -> int:
        n = 0
        if "heads" in self.pruning_types or "layer" in self.pruning_types:
            n += self.params_per_head * self.total_heads
        if "intermediate" in self.pruning_types:
            n += self.params_per_intermediate_dim * self.total_intermediate
        return n


def init_l0_params(cfg: L0Config, init_mean: float = 10.0, device=None) -> dict:
    """log-alphas start at `init_mean` (the reference's 10: keep everything),
    both multipliers at 10."""
    L, H, I, W = (cfg.num_hidden_layers, cfg.num_attention_heads,
                  cfg.intermediate_size, cfg.hidden_size)

    def full(*shape, value=init_mean):
        return torch.full(shape, float(value), device=device, requires_grad=True)

    p = {}
    if "hidden" in cfg.pruning_types:
        p["hidden_loga"] = full(W)
    if "heads" in cfg.pruning_types:
        p["heads_loga"] = tuple(full(h) for h in cfg.heads_per_layer) \
            if cfg.heads_per_layer is not None else full(L, H)
    if "intermediate" in cfg.pruning_types:
        p["intermediate_loga"] = tuple(full(i) for i in cfg.intermediate_per_layer) \
            if cfg.intermediate_per_layer is not None else full(L, I)
    if "layer" in cfg.pruning_types:
        p["mha_loga"] = full(L)
        p["ffn_loga"] = full(L)
    p["lambda_1"] = full(value=10.0)
    p["lambda_2"] = full(value=10.0)
    return p


def named_l0(params: Mapping, prefix: str = "") -> dict[str, torch.Tensor]:
    """The leaf tensors of an l0 params dict by name (`heads_loga.3` for a
    ragged row), in a fixed order: the optimizer's view of them."""
    out = {}
    for k, v in params.items():
        if isinstance(v, (list, tuple)):
            out.update({f"{prefix}{k}.{i}": r for i, r in enumerate(v)})
        else:
            out[f"{prefix}{k}"] = v
    return out


def negate_lambda_grads(grads: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The grads with the lagrangian multipliers' negated: a descent step
    on them is an ascent step on the multipliers (the reference's
    adversarial update)."""
    return {k: -g if k.rsplit(".", 1)[-1].startswith("lambda") else g
            for k, g in grads.items()}


def _cdf_qz0(loga: torch.Tensor) -> torch.Tensor:
    """P(z <= 0) under the stretched concrete (l0module.py:141-146)."""
    xn = (0.0 - LIMIT_A) / (LIMIT_B - LIMIT_A)
    logits = math.log(xn) - math.log(1.0 - xn)
    return torch.clamp(torch.sigmoid(logits * TEMPERATURE - loga), EPS, 1 - EPS)


def score_loga(loga: torch.Tensor) -> torch.Tensor:
    """The probability that a gate is nonzero."""
    return 1.0 - _cdf_qz0(loga)


def sample_z(loga: torch.Tensor, generator: torch.Generator | None = None,
             u: torch.Tensor | None = None) -> torch.Tensor:
    """A training-time hard-concrete sample (l0module.py:228-237) from
    uniforms `u` in [EPS, 1 - EPS], drawn from `generator` when not given."""
    if u is None:
        u = torch.rand(loga.shape, generator=generator, device=loga.device) \
            * (1 - 2 * EPS) + EPS
    u = u.to(device=loga.device, dtype=loga.dtype)
    z = torch.sigmoid((torch.log(u) - torch.log(1 - u) + loga) / TEMPERATURE)
    z = z * (LIMIT_B - LIMIT_A) + LIMIT_A
    return torch.clamp(z, 0.0, 1.0)


def deterministic_z(loga: torch.Tensor, soft: bool = True) -> torch.Tensor:
    """The inference-time mask (l0module.py:241-255): the soft sigmoid mask
    with the expected number of zeros set at its smallest entries. The
    count and the entries are chosen on the host with numpy, as the JAX
    package chooses them, so tied entries drop the same way."""
    loga = loga.detach()
    soft_mask = torch.sigmoid(loga / TEMPERATURE * MAGICAL_NUMBER)
    if not soft:
        return soft_mask
    expected_zeros = loga.numel() - float(score_loga(loga).cpu().numpy().sum())
    num_zeros = round(expected_zeros)
    if num_zeros > 0:
        flat = soft_mask.cpu().numpy().reshape(-1).copy()
        flat[np.argsort(flat)[:num_zeros]] = 0.0
        soft_mask = torch.from_numpy(flat.reshape(soft_mask.shape)).to(loga.device)
    return soft_mask


def _deterministic_rows(rows) -> tuple:
    """deterministic_z over ragged per-layer rows with the hard-zero budget
    taken over all rows at once (as for a uniform (L, N) array)."""
    sizes = [r.numel() for r in rows]
    nonempty = [r for r in rows if r.numel()]
    if not nonempty:
        return tuple(r.detach() for r in rows)
    flat = deterministic_z(torch.cat(nonempty))
    out, off = [], 0
    for s in sizes:
        out.append(flat[off:off + s] if s else flat.new_zeros(0))
        off += s
    return tuple(out)


def sample_masks(params: Mapping, training: bool = True, *,
                 generator: torch.Generator | None = None,
                 uniforms: Mapping | None = None) -> dict:
    """The model-facing mask dict {hidden_z, heads_z, mha_z, intermediate_z,
    ffn_z} (None where that type is not pruned); ragged loga give tuple
    masks, so `masks[name][i]` is layer i's in both layouts. In training
    each mask is a fresh sample, from `uniforms[name]` (a tensor, or a
    tuple of rows for ragged loga) where given, else from `generator`."""
    out = dict.fromkeys(MASK_NAMES.values())
    for pname, mname in MASK_NAMES.items():
        if pname not in params:
            continue
        loga = params[pname]
        u = None if uniforms is None else uniforms[mname]
        if isinstance(loga, (list, tuple)):
            if training:
                out[mname] = tuple(sample_z(r, generator, None if u is None else u[i])
                                   for i, r in enumerate(loga))
            else:
                out[mname] = _deterministic_rows(loga)
        elif training:
            out[mname] = sample_z(loga, generator, u)
        else:
            out[mname] = deterministic_z(loga)
    return out


def _score_sums(params: Mapping, key: str, branch, sizes) -> torch.Tensor:
    """sum_i branch[i] * sum(score(loga row i)); a type that is not pruned
    counts its per-layer size."""
    if key in params:
        loga = params[key]
        rows = list(loga) if isinstance(loga, (list, tuple)) else list(loga.unbind(0))
        per_layer = [score_loga(r).sum() if r.numel() else torch.tensor(0.0)
                     for r in rows]
    else:
        per_layer = [torch.tensor(float(s)) for s in sizes]
    return sum(b * s.to(b.device) for b, s in zip(branch, per_layer))


def expected_sparsity(params: Mapping, cfg: L0Config) -> torch.Tensor:
    """1 - the expected kept prunable params / the prunable size
    (l0module.py:150-205)."""
    L = cfg.num_hidden_layers
    device = params["lambda_1"].device
    h_sizes = cfg.heads_per_layer if cfg.heads_per_layer is not None \
        else [cfg.num_attention_heads] * L
    i_sizes = cfg.intermediate_per_layer if cfg.intermediate_per_layer is not None \
        else [cfg.intermediate_size] * L
    mha = score_loga(params["mha_loga"]) if "mha_loga" in params \
        else torch.ones(L, device=device)
    ffn = score_loga(params["ffn_loga"]) if "ffn_loga" in params \
        else torch.ones(L, device=device)
    heads_score = _score_sums(params, "heads_loga", mha, h_sizes)
    inter_score = _score_sums(params, "intermediate_loga", ffn, i_sizes)
    if "hidden_loga" in params:
        hidden = score_loga(params["hidden_loga"]).sum()
        num = hidden * heads_score * cfg.params_per_head / cfg.hidden_size
        num = num + hidden * inter_score * 2
    else:
        num = heads_score * cfg.params_per_head
        num = num + inter_score * cfg.params_per_intermediate_dim
    return 1.0 - num / cfg.prunable_model_size


def lagrangian_loss(params: Mapping, cfg: L0Config, target_sparsity: float,
                    pruned_steps: int = 0, warmup_steps: int = 0,
                    start_sparsity: float = 0.0):
    """The one-sided lagrangian (l0module.py:210-226): only under-sparsity
    is penalized. Returns (loss, expected sparsity, target); the target
    ramps linearly over `warmup_steps`, in fp32 as the JAX package's."""
    device = params["lambda_1"].device
    if warmup_steps > 0:
        frac = torch.clamp(torch.tensor(float(pruned_steps), device=device)
                           / warmup_steps, max=1.0)
        t = (target_sparsity - start_sparsity) * frac + start_sparsity
    else:
        t = torch.tensor(float(target_sparsity), device=device)
    s = expected_sparsity(params, cfg)
    gap = torch.clamp(t - s, min=0.0)
    loss = params["lambda_1"] * gap + params["lambda_2"] * gap ** 2
    return loss, s, t
