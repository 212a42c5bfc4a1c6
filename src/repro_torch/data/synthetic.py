"""Deterministic synthetic data: a CIFAR-like image task and a Markov token
stream.

Counterpart of ``repro/data/synthetic.py`` (``SyntheticImages``,
``TokenStream``, ``synthetic_batch_iterator``). CIFAR-10 and web-scale
token corpora are not available offline, so both training paths are fed
by seeded synthetic generators that are structured (learnable), not pure
noise. Every draw comes from the caller's ``torch.Generator`` and sits
behind a seam that takes injected values (the token stream's first tokens
and successor picks; the images' labels, gain and noise draws, and the
8x8 base field of the class prototypes), so that a test can feed the
reference's draws through the port. ``TokenStream``'s successor table
comes from ``np.random.default_rng(seed)``, as the reference's does, and
equals it exactly.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device


def _tensor(x, dtype, device) -> torch.Tensor:
    """An injected draw (tensor or array) as a tensor of ``dtype`` on
    ``device``; a numpy array is copied (it may be read-only)."""
    if isinstance(x, np.ndarray):
        x = np.array(x)
    return torch.as_tensor(x, dtype=dtype, device=device)


class SyntheticImages:
    """CIFAR-like ``image_hw`` x ``image_hw`` x 3 classification task.

    Each class has a smooth prototype, an 8x8x3 N(0, 1) field upsampled
    bilinearly (half-pixel centres, edge pixels held, as
    ``jax.image.resize(..., "bilinear")`` upsamples); a sample is its
    class's prototype times a gain in [0.5, 1.5) plus ``noise`` times
    N(0, 1) noise. The noise scale sets the achievable accuracy, so early
    exits saturate as in the paper's Fig 3.
    """

    def __init__(self, n_classes: int = 10, *, noise: float = 0.8,
                 image_hw: int = 32, seed: int = 0, device=None, base=None):
        """``base`` [n_classes, 8, 8, 3] injects the prototypes' field; by
        default it is drawn from a generator seeded with ``seed`` on
        ``device`` (the card unless ``"cpu"``)."""
        self.n_classes = n_classes
        self.noise = noise
        self.hw = image_hw
        self.device = resolve_device(device)
        if base is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            base = torch.randn((n_classes, 8, 8, 3), generator=gen,
                               device=self.device)
        base = _tensor(base, torch.float32, self.device)
        up = F.interpolate(base.permute(0, 3, 1, 2), size=(image_hw, image_hw),
                           mode="bilinear", align_corners=False)
        self.prototypes = up.permute(0, 2, 3, 1).contiguous()

    def sample(self, generator, batch: int, *, labels=None, gain_u=None,
               noise_z=None):
        """(images [batch, hw, hw, 3] float32, labels [batch] int64).
        ``labels`` uniform over the classes, ``gain_u`` [batch, 1, 1, 1]
        U[0, 1) (the gain is 0.5 + it) and ``noise_z`` (the images' shape)
        N(0, 1) are drawn from ``generator`` unless injected."""
        dev = self.device
        if labels is None:
            labels = torch.randint(0, self.n_classes, (batch,),
                                   generator=generator, device=dev)
        labels = _tensor(labels, torch.long, dev)
        protos = self.prototypes[labels]
        if gain_u is None:
            gain_u = torch.rand((batch, 1, 1, 1), generator=generator,
                                device=dev)
        if noise_z is None:
            noise_z = torch.randn(protos.shape, generator=generator,
                                  device=dev)
        gain = 0.5 + _tensor(gain_u, torch.float32, dev)
        noise = self.noise * _tensor(noise_z, torch.float32, dev)
        return protos * gain + noise, labels


class TokenStream:
    """Synthetic language-model corpus with Markov structure: each token
    has ``branching`` successors (a random table), so the stream has
    learnable bigram statistics over any vocabulary."""

    def __init__(self, vocab: int, *, branching: int = 64, seed: int = 0,
                 device=None):
        self.vocab = vocab
        rng = np.random.default_rng(seed)
        self.successors = rng.integers(0, vocab, size=(vocab, branching),
                                       dtype=np.int32)
        self.branching = branching
        self.device = resolve_device(device)
        self._succ = torch.as_tensor(self.successors, dtype=torch.long,
                                     device=self.device)

    def sample(self, generator, batch: int, seq_len: int, *, first=None,
               picks=None):
        """(tokens [batch, seq_len], labels [batch, seq_len]) int64, labels
        the tokens shifted by one. The walk starts at ``first`` [batch]
        (uniform over the vocabulary) and takes successor ``picks[:, t]``
        [batch, seq_len] (uniform over ``branching``) at each step; both
        are drawn from ``generator`` unless injected."""
        dev = self.device
        if first is None:
            first = torch.randint(0, self.vocab, (batch,),
                                  generator=generator, device=dev)
        if picks is None:
            picks = torch.randint(0, self.branching, (batch, seq_len),
                                  generator=generator, device=dev)
        tok = _tensor(first, torch.long, dev)
        picks = _tensor(picks, torch.long, dev)
        toks = [tok]
        for t in range(seq_len):
            tok = self._succ[tok, picks[:, t]]
            toks.append(tok)
        tokens = torch.stack(toks, dim=1)                     # [B, S + 1]
        return tokens[:, :-1], tokens[:, 1:]


def synthetic_batch_iterator(sampler, generator, *args) -> Iterator:
    """``sampler(generator, *args)`` forever (the reference splits a key
    per batch; here the draws advance one generator)."""
    while True:
        yield sampler(generator, *args)
