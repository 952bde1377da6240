"""Synthetic instruction-like token pipeline with non-IID client partition.

The port's own copy of ``repro.data.synthetic`` (pure numpy, kept line
for line so batches are ``array_equal`` to the JAX package's): the port
imports nothing of that package.

Alpaca-GPT4 is not available offline (DESIGN.md §7), so we generate
sequences with *learnable structure*: each client draws from a mixture of
a shared global bigram permutation and a client-specific one. The mixture
weight per client comes from a Dirichlet(α) draw — small α means highly
non-IID clients, matching the paper's federated setting (20 devices,
OpenFedLLM split).

The task is genuinely learnable (next token is a deterministic function
of the current token within each mode), so loss/accuracy curves behave
like real fine-tuning and method *orderings* are meaningful.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FederatedData:
    vocab: int
    n_clients: int
    global_perm: np.ndarray          # (V,)
    client_perms: np.ndarray         # (C, V)
    mix: np.ndarray                  # (C,) P(use client mode)
    noise: float

    def sample_batch(self, client: int, batch: int, seq: int,
                     rng: np.random.RandomState) -> dict:
        """Returns {'tokens': (B, S), 'labels': (B, S)} int32."""
        toks = np.empty((batch, seq + 1), np.int64)
        toks[:, 0] = rng.randint(0, self.vocab, size=batch)
        use_client = rng.rand(batch, seq) < self.mix[client]
        noisy = rng.rand(batch, seq) < self.noise
        rand_next = rng.randint(0, self.vocab, size=(batch, seq))
        for t in range(seq):
            nxt = np.where(use_client[:, t],
                           self.client_perms[client][toks[:, t]],
                           self.global_perm[toks[:, t]])
            toks[:, t + 1] = np.where(noisy[:, t], rand_next[:, t], nxt)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def eval_batch(self, batch: int, seq: int, seed=1234) -> dict:
        """Held-out split drawn from the *global* mode (the shared task
        all clients contribute to — the federated objective). ``seed``
        may be an int (legacy stream) or a tuple of keyed entropy
        (``(seed, step)`` — see ``keyed_rng``)."""
        rng = _seeded_rng(seed)
        toks = np.empty((batch, seq + 1), np.int64)
        toks[:, 0] = rng.randint(0, self.vocab, size=batch)
        for t in range(seq):
            toks[:, t + 1] = self.global_perm[toks[:, t]]
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


def make_federated_data(vocab: int, n_clients: int = 20, *,
                        alpha: float = 0.5, noise: float = 0.05,
                        seed=0) -> FederatedData:
    """``seed`` may be an int (legacy stream, bit-stable) or a tuple of
    keyed entropy for a distinct corpus (e.g. ``(seed, "pretrain")``)."""
    rng = _seeded_rng(seed)
    gp = rng.permutation(vocab)
    cps = np.stack([rng.permutation(vocab) for _ in range(n_clients)])
    # Dirichlet(α) over [client-mode, global-mode] per client
    mix = rng.dirichlet([alpha, alpha], size=n_clients)[:, 0]
    return FederatedData(vocab=vocab, n_clients=n_clients, global_perm=gp,
                         client_perms=cps, mix=mix, noise=noise)


def _entropy_int(e) -> int:
    """One SeedSequence entropy word: ints pass through, string labels
    map to their (stable, platform-independent) byte value — so streams
    can be keyed like ``keyed_rng(seed, "cohort")`` without magic
    numbers colliding with real ids."""
    if isinstance(e, str):
        return int.from_bytes(e.encode("utf-8"), "big")
    return int(e)


def keyed_rng(*entropy) -> np.random.RandomState:
    """THE keyed-stream recipe: a ``RandomState`` seeded from the
    ``SeedSequence`` of a key tuple (ints and/or string labels). Every
    deterministic per-(seed, client, round, ...) stream in the repo
    (round batches, cohort sampling, device profiles, availability
    draws) derives through here, so the construction can never silently
    diverge between subsystems."""
    ss = np.random.SeedSequence(tuple(_entropy_int(e) for e in entropy))
    return np.random.RandomState(np.random.MT19937(ss))


def seed_entropy(seed) -> tuple:
    """Normalize an int-or-tuple seed to ``SeedSequence`` entropy words,
    so helpers taking a ``seed`` argument can be keyed with composite
    entropy (``(base_seed, stage)``) while plain ints keep working."""
    return tuple(seed) if isinstance(seed, tuple) else (seed,)


def derived_seeds(n: int, *entropy) -> list:
    """``n`` distinct deterministic 31-bit seeds keyed on ``entropy``
    words — the ``SeedSequence`` replacement for ``base + i`` arithmetic
    (which collides across bases: base 0 seed 3 == base 3 seed 0)."""
    if n <= 0:
        return []
    ss = np.random.SeedSequence(tuple(_entropy_int(e) for e in entropy))
    return [int(x) for x in ss.generate_state(n, dtype=np.uint32) >> 1]


def _seeded_rng(seed) -> np.random.RandomState:
    """Int seed -> the legacy ``RandomState(seed)`` stream (bit-stable
    with pre-keyed data); tuple seed -> ``keyed_rng`` tuple entropy."""
    if isinstance(seed, tuple):
        return keyed_rng(*seed)
    return np.random.RandomState(seed)


def client_rng(seed, client: int) -> np.random.RandomState:
    """Per-client stream keyed on ``(*seed, client)`` — a client's draws
    never depend on which other clients were sampled alongside it.

    ``seed`` may be an int or a tuple of ints (e.g. ``(base_seed,
    round)``): tuple components feed the ``SeedSequence`` entropy
    directly, so composite keys can never collide the way arithmetic
    like ``seed * 10_000 + round`` did across base seeds. A plain int
    produces the same stream as before (``(seed,) + (client,)``)."""
    entropy = tuple(seed) if isinstance(seed, tuple) else (seed,)
    return keyed_rng(*entropy, client)


def client_round_batches(data: FederatedData, clients, k_steps: int,
                         batch: int, seq: int, seed) -> dict:
    """Stacked per-client local-step batches: arrays (C, K, B, S).

    Each client draws from its own ``client_rng(seed, c)`` stream, so
    the batches are independent of the client's *position* in the
    sampled list (the old single sequential ``RandomState`` made client
    c's data depend on every client sampled before it). ``seed`` may be
    a tuple (see ``client_rng``)."""
    toks, labs = [], []
    for c in clients:
        rng = client_rng(seed, int(c))
        bt, bl = [], []
        for _ in range(k_steps):
            b = data.sample_batch(int(c), batch, seq, rng)
            bt.append(b["tokens"])
            bl.append(b["labels"])
        toks.append(np.stack(bt))
        labs.append(np.stack(bl))
    return {"tokens": np.stack(toks), "labels": np.stack(labs)}
