"""Evolution search over one-shot supernet configs.

Framework rebuild of AutoFormer/evolution.py:22-283 (EvolutionSearcher):
population of candidate configs, parameter-window legality filter, top-k
selection by fitness, mutation + crossover, checkpointable state. Decoupled
from any model family: the caller provides `sample_fn` (rng -> config),
`mutate_fn`, `crossover_fn`, `is_legal_extra` and `eval_fn(config) -> score`.

A copy of `cream_tpu/nas/evolution.py` (pure numpy): one seed gives the
JAX searcher's candidates, history and top-k. The JAX searcher's
`batch_eval_fn` (a chunk of candidates vmapped over its masked supernet)
has no counterpart: the port scores candidates one by one, in the order
and with the scores of JAX's either path.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable

import numpy as np


def _freeze(config: dict):
    """Hashable key for a config dict (canonical JSON)."""
    return json.dumps(config, sort_keys=True)


@dataclasses.dataclass
class EvolutionSearcher:
    sample_fn: Callable[[np.random.Generator], dict]
    eval_fn: Callable[[dict], float]
    mutate_fn: Callable[[np.random.Generator, dict], dict]
    crossover_fn: Callable[[np.random.Generator, dict, dict], dict]
    is_legal_extra: Callable[[dict], bool] = lambda cfg: True
    population_num: int = 50
    select_num: int = 10
    mutation_num: int = 25
    crossover_num: int = 25
    mutation_prob: float = 0.1
    max_epochs: int = 20
    seed: int = 0

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)
        self.visited: set = set()
        self.top_k: list[tuple[float, dict]] = []
        self.epoch = 0
        self.history: list[dict] = []

    # --- state (search checkpointing, evolution.py:51-75) ---
    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "top_k": self.top_k,
                "visited": list(self.visited), "history": self.history,
                "rng_state": self.rng.bit_generator.state}

    def load_state_dict(self, state: dict):
        self.epoch = state["epoch"]
        self.top_k = [(s, c) for s, c in state["top_k"]]
        self.visited = set(state["visited"])
        self.history = state["history"]
        self.rng.bit_generator.state = state["rng_state"]

    # --- internals ---
    def _try_candidate(self, config: dict) -> bool:
        key = _freeze(config)
        if key in self.visited or not self.is_legal_extra(config):
            return False
        self.visited.add(key)
        self._record(config, float(self.eval_fn(config)))
        return True

    def _record(self, config: dict, score: float):
        self.top_k.append((score, config))
        self.top_k.sort(key=lambda t: -t[0])
        self.top_k = self.top_k[:max(self.select_num, 50)]
        self.history.append({"epoch": self.epoch, "score": score,
                             "config": config})

    def _fill(self, n: int, gen: Callable[[], dict], max_tries_factor: int = 20):
        produced = 0
        tries = 0
        while produced < n and tries < n * max_tries_factor:
            tries += 1
            if self._try_candidate(gen()):
                produced += 1
        return produced

    # --- the search loop (evolution.py:242-283) ---
    def search(self, log=print) -> list[tuple[float, dict]]:
        if self.epoch == 0:
            log(f"evolution: random population {self.population_num}")
            self._fill(self.population_num, lambda: self.sample_fn(self.rng))
        while self.epoch < self.max_epochs:
            self.epoch += 1
            parents = [c for _, c in self.top_k[:self.select_num]]
            if not parents:
                break
            self._fill(self.mutation_num,
                       lambda: self.mutate_fn(
                           self.rng, parents[self.rng.integers(len(parents))]))
            self._fill(self.crossover_num,
                       lambda: self.crossover_fn(
                           self.rng,
                           parents[self.rng.integers(len(parents))],
                           parents[self.rng.integers(len(parents))]))
            best = self.top_k[0]
            log(f"evolution epoch {self.epoch}: best={best[0]:.4f} "
                f"cfg={best[1]}")
        return self.top_k[:self.select_num]


def autoformer_mutate(rng: np.random.Generator, config: dict, space,
                      prob: float = 0.1) -> dict:
    """Per-gene re-sampling (AutoFormer evolution.py get_mutation:154-211)."""
    from cream_tpu_torch.models.autoformer import sample_config

    new = sample_config(rng, space)
    depth = config["layer_num"] if rng.random() >= prob else new["layer_num"]
    out = {"layer_num": depth,
           "embed_dim": [config["embed_dim"][0] if rng.random() >= prob
                         else new["embed_dim"][0]] * depth,
           "num_heads": [], "mlp_ratio": []}
    for i in range(depth):
        src = config if (i < config["layer_num"] and rng.random() >= prob) else new
        j = min(i, src["layer_num"] - 1)
        out["num_heads"].append(src["num_heads"][j])
        out["mlp_ratio"].append(src["mlp_ratio"][j])
    return out


def autoformer_crossover(rng: np.random.Generator, a: dict, b: dict) -> dict:
    """Gene-wise random pick from two parents (evolution.py:212-241)."""
    depth = a["layer_num"] if rng.random() < 0.5 else b["layer_num"]
    emb = a["embed_dim"][0] if rng.random() < 0.5 else b["embed_dim"][0]
    out = {"layer_num": depth, "embed_dim": [emb] * depth,
           "num_heads": [], "mlp_ratio": []}
    for i in range(depth):
        src = a if rng.random() < 0.5 else b
        j = min(i, src["layer_num"] - 1)
        out["num_heads"].append(src["num_heads"][j])
        out["mlp_ratio"].append(src["mlp_ratio"][j])
    return out
