"""The port's data pipeline against the JAX package's, bit for bit.

``repro_torch.data.pipeline`` is a copy (numpy on Philox), so every batch
must equal ``repro.data.pipeline``'s exactly: ``synthetic_batch`` for the
text, audio and vision frontends, ``DataPipeline`` at ranks 0 and 1 of
world 2 and at world 1, and ``DataPipeline.from_text``'s packed windows.
"""
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke
from repro.data import DataPipeline as JaxPipeline
from repro.data import synthetic_batch as jax_synthetic
from repro_torch.configs import get_smoke_config
from repro_torch.data import ByteTokenizer, DataPipeline, synthetic_batch

# text, audio and vision frontends
ARCHS = ["stablelm-1.6b", "hubert-xlarge", "internvl2-26b"]
TEXT = ("Akita: a high usability simulation framework for computer "
        "architecture. " * 12)


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_batch_bit_for_bit(arch):
    for step in (0, 7):
        for rank in (0, 1):
            _equal(synthetic_batch(get_smoke_config(arch), 4, 32, 3, step,
                                   rank, 2),
                   jax_synthetic(jax_smoke(arch), 4, 32, 3, step, rank, 2))


@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_bit_for_bit_at_both_ranks(arch):
    for world, ranks in ((1, (0,)), (2, (0, 1))):
        for rank in ranks:
            a = DataPipeline(get_smoke_config(arch), 4, 24, seed=5,
                             rank=rank, world=world)
            b = JaxPipeline(jax_smoke(arch), 4, 24, seed=5, rank=rank,
                            world=world)
            for step in (0, 1, 11):
                _equal(a(step), b(step))
    # the two ranks' halves make up the world-1 batch
    whole = DataPipeline(get_smoke_config(arch), 4, 24, seed=5)(3)
    halves = [DataPipeline(get_smoke_config(arch), 4, 24, seed=5, rank=r,
                           world=2)(3) for r in (0, 1)]
    for k in whole:
        np.testing.assert_array_equal(
            whole[k], np.concatenate([h[k] for h in halves]))


def test_from_text_bit_for_bit_at_both_ranks():
    cfg, jcfg = get_smoke_config("stablelm-1.6b"), jax_smoke("stablelm-1.6b")
    for rank in (0, 1):
        a = DataPipeline.from_text(cfg, TEXT, 4, 16, rank=rank, world=2)
        b = JaxPipeline.from_text(jcfg, TEXT, 4, 16, rank=rank, world=2)
        np.testing.assert_array_equal(a.corpus, b.corpus)
        for step in (0, 2, 9):
            _equal(a(step), b(step))
    assert ByteTokenizer().decode(ByteTokenizer().encode(TEXT)) == TEXT
