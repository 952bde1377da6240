"""The benchmark's frozen copy of the synthetic federated corpus.

Every stream is keyed by ``SeedSequence`` entropy, so any ``--seed`` (also
one past 32 bits) gives one corpus, one cohort per round and one batch per
(client, step). The arithmetic is the synthetic generator's: a global
bigram permutation and one per client, mixed per client by a Dirichlet
draw, with label noise. The harness hands the arrays to the program; the
reference draws the cohorts and batches again from here.
"""
from __future__ import annotations

import numpy as np


def _word(e) -> int:
    return int.from_bytes(e.encode("utf-8"), "big") if isinstance(e, str) \
        else int(e)


def keyed_rng(*entropy) -> np.random.RandomState:
    """A ``RandomState`` on the ``SeedSequence`` of a key tuple."""
    ss = np.random.SeedSequence(tuple(_word(e) for e in entropy))
    return np.random.RandomState(np.random.MT19937(ss))


def make_corpus(vocab: int, n_clients: int, alpha: float, noise: float,
                seed: int) -> dict:
    """The corpus arrays: ``global_perm`` (V,), ``client_perms`` (C, V),
    ``mix`` (C,) and ``noise``."""
    rng = keyed_rng(seed, "fedbench-corpus")
    gp = rng.permutation(vocab)
    cps = np.stack([rng.permutation(vocab) for _ in range(n_clients)])
    mix = rng.dirichlet([alpha, alpha], size=n_clients)[:, 0]
    return {"vocab": vocab, "n_clients": n_clients, "global_perm": gp,
            "client_perms": cps, "mix": mix, "noise": noise}


def sample_batch(corpus: dict, client: int, batch: int, seq: int,
                 rng: np.random.RandomState) -> dict:
    """One local step's {'tokens', 'labels'} (B, S) int32 for ``client``."""
    vocab = corpus["vocab"]
    toks = np.empty((batch, seq + 1), np.int64)
    toks[:, 0] = rng.randint(0, vocab, size=batch)
    use_client = rng.rand(batch, seq) < corpus["mix"][client]
    noisy = rng.rand(batch, seq) < corpus["noise"]
    rand_next = rng.randint(0, vocab, size=(batch, seq))
    cp, gp = corpus["client_perms"][client], corpus["global_perm"]
    for t in range(seq):
        nxt = np.where(use_client[:, t], cp[toks[:, t]], gp[toks[:, t]])
        toks[:, t + 1] = np.where(noisy[:, t], rand_next[:, t], nxt)
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def eval_batch(corpus: dict, batch: int, seq: int, seed: int = 1234) -> dict:
    """The held-out batch from the global mode, on the ``RandomState(seed)``
    stream the program's eval draws."""
    rng = np.random.RandomState(seed)
    toks = np.empty((batch, seq + 1), np.int64)
    toks[:, 0] = rng.randint(0, corpus["vocab"], size=batch)
    for t in range(seq):
        toks[:, t + 1] = corpus["global_perm"][toks[:, t]]
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def cohorts(seed: int, n_clients: int, n_sample: int, n_rounds: int):
    """The clients sampled in each of the first ``n_rounds`` rounds: one
    ``choice`` a round on the ``(seed, "cohort")`` stream."""
    rng = keyed_rng(seed, "cohort")
    return [rng.choice(n_clients, n_sample, replace=False)
            for _ in range(n_rounds)]


def followed(seed: int, n_rounds: int, n_sample: int, k_local: int,
             n_steps: int):
    """[(client, start), ...] a round: which of the round's sampled
    clients (its place in the cohort) the check follows, and from which
    local step, for ``n_steps`` steps, on the ``(seed, "followed")``
    stream. Round 0 starts at step 0, from the benchmark's inputs alone;
    a later round at any step that leaves room for ``n_steps``."""
    rng = keyed_rng(seed, "followed")
    out = []
    for r in range(n_rounds):
        client = int(rng.randint(0, n_sample))
        start = int(rng.randint(0, k_local - n_steps + 1))
        out.append((client, 0 if r == 0 else start))
    return out


def client_steps(corpus: dict, seed: int, rnd: int, client: int,
                 start: int, n_steps: int, batch: int, seq: int):
    """Local-step batches ``start`` to ``start + n_steps - 1`` of
    ``client`` in round ``rnd``: its own ``(seed, rnd, client)`` stream,
    one batch a step."""
    rng = keyed_rng(seed, rnd, int(client))
    out = [sample_batch(corpus, int(client), batch, seq, rng)
           for _ in range(start + n_steps)]
    return out[start:]
