"""K1/K4 (MaxSim, exact and int8): the wrapper's launch split, the choice of
kernel, and the port's plain versions against the JAX package's Pallas
kernels in interpret mode at the shapes the split produces (rows just past a
launch, a query longer than a launch, one query)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_colpali_tpu.ops import maxsim as JM
from multimodal_colpali_tpu_torch.ops import maxsim as TM

torch.set_num_threads(1)
R = TM.ROWS_PER_LAUNCH


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


@pytest.mark.parametrize("b,nq", [
    (1, 32), (4, 32), (120, 32), (9, 32), (8, 32), (3, 257),
    (2, 600), (5, 1), (7, 0), (300, 1), (1, 256), (10, 100),
])
def test_launch_groups_take_whole_queries(b, nq):
    groups = TM.launch_groups(b, nq)
    covered = [q for b0, nb in groups for q in range(b0, b0 + nb)]
    assert covered == list(range(b))                      # each query once, in order
    for _, nb in groups:
        assert nb >= 1
        assert nb * nq <= R or nb == 1                    # a longer query goes alone
        assert nb <= R                                    # at least a row each
    if nq <= R and nq:
        assert len(groups) == -(-b // (R // nq))          # as few launches as fit


@pytest.mark.parametrize("b,nq", [
    (4, 32), (120, 32), (2, 600), (1, 256), (1, 257), (3, 300),
])
def test_launch_plan_splits_long_queries_into_row_windows(b, nq):
    """Each launch scores rows [r0, r0 + R) of its queries' rows laid end to
    end; every row of every query is scored once, a query's windows in order."""
    covered = []
    for b0, nb, r0 in TM.launch_plan(b, nq):
        assert r0 % R == 0 and (r0 == 0 or nb == 1)
        n = min(R, nb * nq - r0)
        assert 0 < n <= R and (nb * nq <= R or nb == 1)
        covered += [(b0 + r // nq, r % nq) for r in range(r0, r0 + n)]
    assert covered == [(q, r) for q in range(b) for r in range(nq)]


@pytest.mark.parametrize("dtype,dim,nq,want", [
    (torch.bfloat16, 128, 32, True), (torch.int8, 128, 32, True), (torch.bfloat16, 16, 5, True),
    (torch.int8, 48, 3, True), (torch.float32, 128, 32, False), (torch.bfloat16, 72, 32, False),
    (torch.int8, 8, 32, False), (torch.bfloat16, 144, 32, False), (torch.bfloat16, 128, 0, False),
])
def test_tensor_core_path_by_dtype_dim(dtype, dim, nq, want):
    assert TM.tensor_core_path(dtype, dim, nq) is want


def test_rows_per_launch_is_the_tensor_core_kernels():
    """The wrapper's rows a launch are the tensor-core kernel's rows: 8 warps
    of two m16 tiles."""
    src = (Path(TM.__file__).parents[1] / "csrc" / "maxsim.cu").read_text()
    assert int(re.search(r"constexpr int kWarps = (\d+);", src).group(1)) * 32 == R
    assert "constexpr int kRows = 32 * kWarps;" in src


@pytest.mark.parametrize("b,nq", [(4, 32), (120, 32), (2, 600), (1024, 1), (2500, 3)])
def test_cuda_core_plan_takes_up_to_1024_queries_a_launch(b, nq):
    """The CUDA-core kernel walks a launch's rows in passes itself, so a call
    is one launch a 1,024 queries, each from row 0."""
    plan = TM._plan(False, b, nq)
    assert [(b0, nb) for b0, nb, _ in plan] == [(b0, min(1024, b - b0))
                                                for b0 in range(0, b, 1024)]
    assert all(r0 == 0 for _, _, r0 in plan)
    assert TM._plan(True, b, nq) == TM.launch_plan(b, nq)


# the launch split's shapes: one query, rows just past a launch (9 x 32 =
# 288), a query longer than a launch (300 rows), a batch that fills one
SHAPES = {"b1": (1, 32, 9, 40), "past_r": (9, 32, 5, 24), "nq_gt_r": (2, 300, 4, 20),
          "full_r": (8, 32, 6, 17)}


def _case(name, dim=128):
    rng = np.random.default_rng(list(SHAPES).index(name) + 100)
    b, nq, p, nt = SHAPES[name]
    q = rng.standard_normal((b, nq, dim), dtype=np.float32)
    d = rng.standard_normal((p, nt, dim), dtype=np.float32)
    q_lens = rng.integers(1, nq + 1, size=b).astype(np.int32)
    q_lens[0] = nq
    d_lens = rng.integers(1, nt + 1, size=p).astype(np.int32)
    d_lens[1] = 0                                  # an empty page
    return q, d, q_lens, d_lens


@pytest.mark.parametrize("name", list(SHAPES))
def test_maxsim_bf16_plain_matches_pallas_interpret_at_split_shapes(name):
    q, d, q_lens, d_lens = _case(name)
    qb, db = _j(q).astype(jnp.bfloat16), _j(d).astype(jnp.bfloat16)
    want = np.asarray(JM.maxsim_scores_pallas(qb, db, _j(q_lens), _j(d_lens), block_pages=4,
                                              interpret=True))
    got = TM.maxsim_scores(_t(q).to(torch.bfloat16), _t(d).to(torch.bfloat16), _t(q_lens),
                           _t(d_lens)).numpy()
    # bf16 products are exact in float32; the sums run in another order
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[:, 1], -q_lens.astype(np.float64) * 1e30, rtol=1e-5)


@pytest.mark.parametrize("name", list(SHAPES))
def test_maxsim_int8_plain_matches_pallas_interpret_at_split_shapes(name):
    q, d, q_lens, d_lens = _case(name)
    jc, js = JM.quantize_corpus_int8(_j(d))
    want = np.asarray(JM.maxsim_scores_int8_pallas(_j(q), jc, js, _j(q_lens), _j(d_lens),
                                                   block_pages=4, interpret=True))
    tc, ts = TM.quantize_corpus_int8(_t(d))
    got = TM.maxsim_scores_int8(_t(q), tc, ts, _t(q_lens), _t(d_lens)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[:, 1], -q_lens.astype(np.float64) * 1e30, rtol=1e-5)


@pytest.mark.parametrize("name", ["past_r", "nq_gt_r"])
def test_maxsim_plain_scores_each_launch_alone(name):
    """Scoring each launch's queries alone, as the card's wrapper splits them,
    gives what one call over all of them gives: a query's score depends on
    no other query."""
    q, d, q_lens, d_lens = _case(name)
    qt, dt = _t(q).to(torch.bfloat16), _t(d).to(torch.bfloat16)
    whole = TM.maxsim_scores(qt, dt, _t(q_lens), _t(d_lens))
    parts = torch.cat([TM.maxsim_scores(qt[b0: b0 + nb], dt, _t(q_lens[b0: b0 + nb]),
                                        _t(d_lens))
                       for b0, nb in TM.launch_groups(*q.shape[:2])])
    assert torch.equal(parts, whole)


def test_maxsim_sweep_needs_a_card(monkeypatch, capsys):
    from multimodal_colpali_tpu_torch import maxsim_sweep

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert maxsim_sweep.main([]) == 2
    assert "CUDA is not available" in capsys.readouterr().err
