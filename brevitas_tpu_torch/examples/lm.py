"""Character-LM data (port of ``brevitas_tpu/examples/lm.py``; ported: the
built-in corpus ``_CORPUS`` and the batch draw ``_batches``, which
``examples.llm_ptq`` takes). The ``train`` CLI is not ported yet.
"""

import numpy as np
import torch

# enough structure for a tiny model to beat the unigram entropy quickly
_CORPUS = (
    "the quick brown fox jumps over the lazy dog. "
    "pack my box with five dozen liquor jugs. "
    "how vexingly quick daft zebras jump! "
    "sphinx of black quartz, judge my vow. "
) * 64


def _batches(text: str, seq_len: int, batch: int, steps: int, seed: int = 0):
    """(inputs, targets, vocab): ``steps`` batches of ``batch`` windows of
    ``seq_len`` characters at random starts, the targets shifted by one,
    as (steps, batch, seq_len) int64 tensors on the CPU; the starts are
    the JAX package's numpy draws."""
    codes = np.frombuffer(text.encode("latin-1"), dtype=np.uint8)
    vocab = int(codes.max()) + 1
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(codes) - seq_len - 1, (steps, batch))
    idx = starts[..., None] + np.arange(seq_len + 1)
    chunks = codes[idx].astype(np.int64)  # (steps, batch, seq + 1)
    return torch.from_numpy(chunks[..., :-1]), torch.from_numpy(chunks[..., 1:]), vocab
