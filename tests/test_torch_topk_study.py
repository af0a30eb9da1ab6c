"""The top-k study (stereo_visual_slam_tpu_torch/profiling/micro_topk.py)
on the CPU: every strategy that claims the production result equals it on
small seeded inputs, with ties and without (the tie order included), the
checks reject a wrong tie order, the exact torch.topk-based top-k equals
the stable sort at every k, the strategies keep the JAX tool's letters and
labels at its shapes, the absent ones say why, and the entry point refuses
a missing card. The times come from the card only."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from stereo_visual_slam_tpu_torch.ops import fast as fast_ops
from stereo_visual_slam_tpu_torch.profiling import micro_topk
from stereo_visual_slam_tpu_torch.utils.config import Config, small_config

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(R=2, H=64, W=128, K=40, C=128, NB=16, nnz=60)
CLAIMS = ("A", "F", "K", "Q", "R", "U")


def _strategies(ties, shape=SMALL):
    inp = micro_topk.make_inputs(small_config(), "cpu", shape, ties=ties)
    return inp, {s.letter: s for s in micro_topk.strategies(inp)}


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("letter", CLAIMS)
def test_claimed_production_result(letter, ties):
    inp, strategies = _strategies(ties)
    if ties:   # nearly every pick is a tie
        assert len(torch.unique(inp["x"])) <= 5
    st = strategies[letter]
    assert st.check is not None and st.check() is True


def test_which_strategies_claim_and_which_are_absent():
    _, strategies = _strategies(False)
    assert sorted(k for k, s in strategies.items() if s.check) == sorted(CLAIMS)
    absent = {k: s.absent for k, s in strategies.items() if s.fn is None}
    assert sorted(absent) == ["G", "O"]
    assert "no torch counterpart" in absent["G"] and "XLA" in absent["O"]


def test_checks_reject_a_wrong_tie_order():
    x = torch.tensor([[3.0, 5.0, 3.0, 5.0, 1.0, 3.0]])
    vals, idx = fast_ops.top_k_stable(x, 3)
    assert idx.tolist() == [[1, 3, 0]]
    assert micro_topk._same_stable_topk(lambda: (vals, idx), x, 3)
    assert not micro_topk._same_stable_topk(lambda: (vals, idx[:, [0, 1, 2]].flip(-1)), x, 3)
    assert not micro_topk._same_stable_topk(lambda: (vals, torch.tensor([[3, 1, 0]])), x, 3)
    assert not micro_topk._same_stable_topk(lambda: (vals, torch.tensor([[1, 3, 2]])), x, 3)
    score = torch.zeros((1, 4, 4))
    score[0, 1, 1] = 2.0
    ts, yx = fast_ops.nms_topk(score, 1)
    assert yx.tolist() == [[[1, 1]]]
    assert not micro_topk._same_nms_topk([((ts, yx.flip(-1) - 1), (ts, yx))])


@pytest.mark.parametrize("k", [1, 7, 59, 60, 61, 600])
def test_exact_topk_equals_the_stable_sort(k):
    """At every k, with fewer nonzeros than k (61, 600: zeros tie) and on
    integer scores that tie everywhere."""
    rng = np.random.default_rng(k)
    x = np.zeros((3, 700), np.float32)
    for r in range(3):
        x[r, rng.choice(700, 60, replace=False)] = rng.integers(1, 4, 60)
    x = torch.from_numpy(x)
    vals, idx = micro_topk.topk_exact(x, k)
    want_v, want_i = fast_ops.top_k_stable(x, k)
    assert torch.equal(vals, want_v) and torch.equal(idx, want_i)


def test_run_checks_and_times_every_strategy():
    result = micro_topk.run(small_config(), "cpu", r=1, best_of=1, shape=SMALL, ties=True)
    rows = {row["letter"]: row for row in result["rows"]}
    assert list(rows) == list("ABCDEFGHIJLMNOPQRSKTU")
    for letter, row in rows.items():
        if letter in "GO":
            assert row["row"] is None and row["absent"]
        else:
            assert row["row"]["wall_ms"] is not None and row["row"]["device_ms"] is None
        assert row["production_result"] == (True if letter in CLAIMS else None)
    text = micro_topk.render(result)
    assert "G approx_max_k (recall .95)" in text and "absent" in text
    assert "# the production nms_topk: J " in text


def _jax_labels():
    src = (REPO / "tools" / "micro_topk.py").read_text()
    labels = re.findall(r'loop_time\(\s*\w+,\s*f?"([^"]*)"', src)
    M = (384 // 2) * (1280 // 2)
    return [lab.replace("{M}", str(M)).replace("{K}", "536").replace("{C}", "1280")
            for lab in labels]


def test_letters_and_labels_are_the_jax_tools():
    """At the JAX tool's shapes and Config()'s 8 levels."""
    inp = micro_topk.make_inputs(Config(), "cpu")
    assert inp["shape"]["M"] == 122880 and inp["x"].shape == (8, 122880)
    assert int((inp["x"] > 0).sum()) == 8 * 900
    ours = [s.label for s in micro_topk.strategies(inp) if s.letter not in "TU"]
    assert ours == _jax_labels()


def test_entry_point_refuses_a_missing_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert micro_topk.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
