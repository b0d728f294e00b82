"""The offline render's host<->card copies (models/stretch.py) on the CPU.

On the card, host input is staged to the device a chunk of whole clips at
a time through two pinned blocks, and the render comes back in pinned
host memory (the card's cases are in tests/test_torch_cuda.py).  Here the
same chunk walk runs through pageable blocks to a CPU tensor: it covers
the batch exactly and converts dtype and strides as `torch.as_tensor`
does, bit for bit.  A model on the CPU returns what it returned before:
the render of `torch.as_tensor(audio, dtype=float32)`, in a CPU tensor.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from signalsmith_stretch_torch import engine  # noqa: E402
from signalsmith_stretch_torch.models import StretchModel  # noqa: E402
from signalsmith_stretch_torch.models import stretch  # noqa: E402

PER = stretch.STAGE_CLIPS
# one clip, a part of a chunk, whole chunks, and one clip above them
BATCHES = [1, 3, 32, 4 * PER + 1]
RATE, N = 8000, 8000


def _clips(batch, seed=0):
    rng = np.random.default_rng(seed)
    return 0.3 * rng.standard_normal((batch, 2, N))


@pytest.mark.parametrize("per", [1, 3, PER])
@pytest.mark.parametrize("batch", BATCHES)
def test_chunks_cover_the_batch(batch, per):
    chunks = stretch.clip_chunks(batch, per)
    assert [i for a, b in chunks for i in range(a, b)] == list(range(batch))
    assert all(0 < b - a <= per for a, b in chunks)
    assert len(chunks) == -(-batch // per)


def _host(kind, batch):
    """A host batch of the given kind: its values, and the tensor or array
    the caller passes."""
    x = _clips(batch)
    if kind == "float64":
        return x
    if kind == "strided":            # every other sample of a wider array
        wide = np.repeat(x.astype(np.float32), 2, axis=-1)
        return wide[..., ::2]
    if kind == "transposed":         # channels outermost in memory
        return np.ascontiguousarray(
            x.astype(np.float32).transpose(1, 0, 2)).transpose(1, 0, 2)
    return torch.as_tensor(x.astype(np.float32))   # a CPU tensor


@pytest.mark.parametrize("kind", ["float64", "strided", "transposed",
                                  "tensor"])
@pytest.mark.parametrize("batch", BATCHES)
def test_copy_in_walk_is_as_tensor(batch, kind):
    """The staged walk gives float32 bit-equal to torch.as_tensor's."""
    host = _host(kind, batch)
    got = stretch.copy_in(torch.as_tensor(host), "cpu")
    want = torch.as_tensor(host, dtype=torch.float32)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert got.device.type == "cpu" and torch.equal(got, want)


@pytest.mark.parametrize("entry", ["batched_numpy", "batched_tensor",
                                   "forward"])
def test_cpu_model_returns_what_it_did(entry):
    """A model on the CPU: the render of the input as a float32 tensor, on
    the CPU, as engine.render_exact gives it."""
    model = StretchModel.build(2, RATE, N, int(N * 1.25), device="cpu")
    x = _clips(3, seed=1)
    want = engine.render_exact(torch.as_tensor(x, dtype=torch.float32),
                               model.plan, model.controls, model.flags)
    if entry == "forward":
        got, want = model(x[1]), want[1]
    else:
        got = model.batched(x if entry == "batched_numpy"
                            else torch.as_tensor(x))
    assert got.device.type == "cpu" and torch.equal(got, want)


@pytest.mark.parametrize("audio,got", [
    (np.zeros((1, 1, N), np.float32), "(1, 1, 8000)"),
    (np.zeros((2, N), np.float32), "(2, 8000)"),
    (torch.zeros(2, 2, N + 1), "(2, 2, 8001)"),
    ([[[0.0] * 4] * 2], "(1, 2, 4)"),
], ids=["channels", "no_batch", "tensor_length", "list"])
def test_shape_error_unchanged(audio, got):
    model = StretchModel.build(2, RATE, N, N, device="cpu")
    with pytest.raises(ValueError, match=(
            rf"^expected \[batch, 2, {N}\] audio, got {re.escape(got)}$")):
        model.batched(audio)
