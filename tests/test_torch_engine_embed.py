"""``EncoderEmbedder`` as a batch device UDF under the port's engine:
``table_from_rows(...).select(embedding=emb(pw.this.data))`` run by
``GraphRunner.run_batch``, against the JAX package's same program over
``JaxEncoderEmbedder`` with the same numpy weights (tiny encoder, f32, mean
pooling), padded and ragged.

Checked: the same keys, times and diffs as the reference; embeddings within
``atol=1e-4`` of the reference's (the tolerance tests/test_torch_slice.py
states for this encoder: f32 sums in a different order on each side); and
bit for bit equal to the port's own ``embed_batch`` over the same ticks,
split into the same ``max_batch_size`` batches the UDF sees.

The JAX side runs with ``PATHWAY_AUTO_JIT=0`` and
``PATHWAY_DEVICE_INFLIGHT=1`` (see tests/test_torch_table.py): the same
interpreted compile and the same serial schedule as the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals.runner import GraphRunner as JRunner
from pathway_tpu.models.encoder import EncoderConfig as JConfig
from pathway_tpu.xpacks.llm.embedders import JaxEncoderEmbedder
from pathway_tpu_torch.internals import udfs
from pathway_tpu_torch.internals.runner import GraphRunner as TRunner
from pathway_tpu_torch.models.encoder import EncoderConfig, init_params_host
from pathway_tpu_torch.ops.attention import ATTENTION
from pathway_tpu_torch.xpacks.llm.embedders import EncoderEmbedder

N_DOCS, PER_TICK = 90, 16  # 6 ticks, the last one short
ATOL = 1e-4


@pytest.fixture(autouse=True)
def _reference_schedule(monkeypatch):
    monkeypatch.setenv("PATHWAY_AUTO_JIT", "0")
    monkeypatch.setenv("PATHWAY_DEVICE_INFLIGHT", "1")


def make_docs(n: int, seed: int) -> list[str]:
    """Random words of a 4096-word vocabulary, of varying lengths so the
    ticks take several width buckets."""
    rng = np.random.default_rng(seed)
    vocab = [f"word{i}" for i in range(4096)]
    lens = rng.integers(3, 60, size=n)
    return [" ".join(vocab[j] for j in rng.integers(0, 4096, size=m))
            for m in lens]


DOCS = make_docs(N_DOCS, seed=0)


def _rows():
    """One tick per PER_TICK documents, at time 2 * tick."""
    return [(doc, 2 * (i // PER_TICK), 1) for i, doc in enumerate(DOCS)]


@pytest.fixture(scope="module")
def params():
    return init_params_host(0, EncoderConfig.tiny())


def _run(pw, Runner, emb):
    docs = pw.debug.table_from_rows(pw.schema_from_types(data=str), _rows(),
                                    is_stream=True)
    out = docs.select(embedding=emb(pw.this.data))
    runner = Runner()
    cap = runner.capture(out)
    runner.run_batch(n_workers=1)
    return sorted(cap.events, key=lambda e: (e[2], int(e[0]), e[3]))


CASES = [(False, None), (True, None), (False, 5), (True, 7)]


@pytest.mark.parametrize("ragged,max_batch", CASES,
                         ids=["padded", "ragged", "padded-max5",
                              "ragged-max7"])
def test_engine_embeddings_match_reference_and_direct(params, ragged,
                                                      max_batch):
    kw = {} if max_batch is None else {"max_batch_size": max_batch}
    jemb = JaxEncoderEmbedder(
        config=JConfig.tiny(compute_dtype=jnp.float32, pooling="mean"),
        params=params, ragged=ragged, **kw)
    temb = EncoderEmbedder(
        config=EncoderConfig.tiny(compute_dtype=torch.float32,
                                  pooling="mean"),
        params=params, ragged=ragged, device="cpu", **kw)
    jev = _run(jpw, JRunner, jemb)
    temb.dispatches = 0
    tev = _run(tpw, TRunner, temb)
    engine_dispatches, temb.dispatches = temb.dispatches, 0

    assert len(tev) == len(jev) == N_DOCS
    assert [(int(k), t, d) for k, _, t, d in tev] \
        == [(int(k), t, d) for k, _, t, d in jev]
    assert {t for _, _, t, _ in tev} == {2 * i for i in range(6)}
    got = np.stack([row[0] for _, row, _, _ in tev])
    ref = np.stack([np.asarray(row[0]) for _, row, _, _ in jev])
    assert got.dtype == np.float32 and got.shape == (N_DOCS, 64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)

    # the engine's rows against the port's direct embed_batch over the same
    # ticks and the same max_batch_size split, bit for bit
    by_key = {int(k): row[0] for k, row, _, _ in tev}
    keys = [int(tpw.debug.hash_values_uncached("row", i, doc))
            for i, doc in enumerate(DOCS)]
    step = max_batch or PER_TICK
    for t0 in range(0, N_DOCS, PER_TICK):
        tick = list(range(t0, min(t0 + PER_TICK, N_DOCS)))
        for lo in range(0, len(tick), step):
            idx = tick[lo:lo + step]
            direct = temb.embed_batch([DOCS[i] for i in idx])
            for i, vec in zip(idx, direct):
                np.testing.assert_array_equal(by_key[keys[i]], vec)
    # the UDF saw the same batches: as many encoder forwards either way
    assert engine_dispatches == temb.dispatches > 0


def test_encoder_embedder_is_a_batch_device_udf(params):
    emb = EncoderEmbedder(config=EncoderConfig.tiny(), params=params,
                          device="cpu")
    assert isinstance(emb, udfs.UDF)
    assert emb.batch and emb.deterministic and emb.device_bound
    assert emb.device == torch.device("cpu")
    expr = emb(tpw.this.data)
    assert expr._batch and expr._device and expr._deterministic
    assert emb.get_embedding_dimension() == 64


def test_engine_marks_the_map_device_bound_and_runs_the_plain_k1_on_cpu(
        params):
    """On CPU tensors the encoder's attention takes K1's plain version, so
    the kernel's launch count does not move; the hosting map operator is
    marked device-bound."""
    emb = EncoderEmbedder(config=EncoderConfig.tiny(), params=params,
                          device="cpu")
    docs = tpw.debug.table_from_rows(tpw.schema_from_types(data=str),
                                     _rows()[:20], is_stream=True)
    runner = TRunner()
    runner.capture(docs.select(embedding=emb(tpw.this.data)))
    before = ATTENTION.launches
    runner.run_batch()
    assert ATTENTION.launches == before
    assert [n.op.device_bound for n in runner.graph.nodes] \
        == [False, True, False]
