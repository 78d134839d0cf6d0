"""The port's REPRO_SANITIZE sanitizer on the CPU: the counterparts of the
JAX package's ``tests/test_sanitize.py``.

``scoring_guard`` replaces ``jax.transfer_guard("disallow")`` with
torch's sync-debug mode, which only a CUDA build has: here its CUDA
branch runs against a stand-in for ``torch.cuda``'s two mode functions
(the card tests in ``test_torch_cuda.py`` run it for real), and on a CPU
device it must do nothing.  The engine's use of it is checked by where
the guard sits: around the scoring dispatch, after the contexts' copy
to the device.  ``assert_no_retrace`` is ported as it is, with the
reference's tests."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import dplr_fwfm  # noqa: E402
from repro_torch.data.synthetic_ctr import SyntheticCTR  # noqa: E402
from repro_torch.models.recsys import fwfm  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CorpusState,
    ScorerRuntime,
    assert_no_retrace,
    check_scores,
    sanitize_enabled,
    scoring_guard,
)
from repro_torch.serving import engine as engine_mod  # noqa: E402


# -- enable knob --------------------------------------------------------------

@pytest.mark.parametrize("value,expect", [
    ("1", True), ("true", True), ("ON", True), ("yes", True),
    ("0", False), ("", False), ("off", False), ("no", False),
])
def test_sanitize_enabled_values(monkeypatch, value, expect):
    monkeypatch.setenv("REPRO_SANITIZE", value)
    assert sanitize_enabled() is expect


def test_sanitize_disabled_when_unset(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    assert sanitize_enabled() is False


# -- the guard ----------------------------------------------------------------

class _SyncMode:
    """A stand-in for torch.cuda's get/set_sync_debug_mode (a CPU build's
    raise: no CUDA), recording every mode set."""

    def __init__(self, monkeypatch, start=0):
        self.mode = start
        self.seen = []
        monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: self.mode)
        monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", self.set)

    def set(self, mode):
        self.mode = {"default": 0, "warn": 1, "error": 2}.get(mode, mode)
        self.seen.append(self.mode)


def test_guard_noop_when_disabled(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    modes = _SyncMode(monkeypatch)
    with scoring_guard("cuda"):
        assert modes.mode == 0
    assert modes.seen == []


def test_guard_noop_on_a_cpu_device(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    with scoring_guard("cpu"):                 # no CUDA call at all on this build
        out = torch.sin(torch.as_tensor(np.arange(3.0)))
    assert out.shape == (3,)
    with scoring_guard(torch.device("cpu")):
        pass


@pytest.mark.parametrize("start", [0, 1])
def test_guard_sets_error_mode_and_restores(monkeypatch, start):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    modes = _SyncMode(monkeypatch, start)
    with scoring_guard(torch.device("cuda", 0)):
        assert modes.mode == 2                 # "error" inside the block
    assert modes.mode == start and modes.seen == [2, start]
    with pytest.raises(KeyError):              # restored on the way out of an error
        with scoring_guard("cuda"):
            raise KeyError("inner")
    assert modes.mode == start


def _engine():
    cfg = dplr_fwfm.make_smoke()
    data = SyntheticCTR(cfg.layout, embed_dim=4, seed=0)
    q = data.ranking_query(40, 0)
    rt = ScorerRuntime(cfg, device="cpu")
    states = [CorpusState(None, q["item_ids"][0], runtime=rt) for _ in range(2)]
    params = fwfm.init(torch.Generator().manual_seed(0), cfg)
    for st in states:
        st.refresh(params)
    return data, states


def test_engine_guards_the_dispatch_not_the_context_copy(monkeypatch):
    """score, topk and fused_topk enter ``scoring_guard(device)`` around
    the runtime's dispatch, and copy the contexts to the device before."""
    data, (st, other) = _engine()
    state = {"inside": False, "entered": []}

    class Guard:
        def __init__(self, device):
            state["entered"].append(torch.device(device))

        def __enter__(self):
            state["inside"] = True

        def __exit__(self, *exc):
            state["inside"] = False
            return False

    def outside(fn):
        def wrapped(*a, **kw):
            assert not state["inside"], "host-to-device copy inside the guard"
            return fn(*a, **kw)
        return wrapped

    def inside(fn):
        def wrapped(*a, **kw):
            assert state["inside"], "dispatch outside the guard"
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(engine_mod, "scoring_guard", Guard)
    monkeypatch.setattr(engine_mod.torch, "as_tensor", outside(torch.as_tensor))
    for name in ("score", "topk", "multi_topk"):
        monkeypatch.setattr(st.runtime, name, inside(getattr(st.runtime, name)))
    ctx = data.context_query(0)["context_ids"]
    st.score(ctx)
    st.topk(ctx, 3)
    engine_mod.fused_topk((st, other), np.stack([ctx, ctx]), 3)
    assert state["entered"] == [torch.device("cpu")] * 3


# -- NaN / inf score checks ---------------------------------------------------

def test_check_scores_passes_clean_and_neg_inf(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    vals = torch.tensor([1.0, -float("inf"), 0.5, -1e30])   # -inf / NEG_INF: masked
    assert check_scores(vals, where="test") is vals
    arr = np.array([2.0, -np.inf], np.float32)
    assert check_scores(arr, where="test") is arr


@pytest.mark.parametrize("as_tensor", [True, False])
def test_check_scores_rejects_nan_and_pos_inf(monkeypatch, as_tensor):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    wrap = torch.tensor if as_tensor else np.asarray
    with pytest.raises(FloatingPointError, match="NaN in test"):
        check_scores(wrap([1.0, float("nan")]), where="test")
    with pytest.raises(FloatingPointError, match=r"\+inf in test"):
        check_scores(wrap([1.0, float("inf")]), where="test")


def test_check_scores_noop_when_disabled(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    vals = torch.tensor([float("nan")])        # ignored: sanitizer off
    assert check_scores(vals, where="test") is vals


# -- the counter assertion ----------------------------------------------------

class _Traced:
    def __init__(self):
        self.trace_count = 0


def test_assert_no_retrace_passes_when_flat():
    t = _Traced()
    with assert_no_retrace(t, label="flat") as guard:
        pass
    assert guard.new_traces == 0


def test_assert_no_retrace_raises_on_growth():
    t = _Traced()
    with pytest.raises(AssertionError, match=r"\[churn\].*grew by 2"):
        with assert_no_retrace(t, label="churn"):
            t.trace_count += 2


def test_assert_no_retrace_allow_budget():
    t = _Traced()
    with assert_no_retrace(t, allow=1):
        t.trace_count += 1


def test_assert_no_retrace_callable_target_and_sum():
    a, b = _Traced(), _Traced()
    with pytest.raises(AssertionError, match="grew by 2"):
        with assert_no_retrace(a, lambda: b.trace_count):
            a.trace_count += 1
            b.trace_count += 1


def test_assert_no_retrace_does_not_mask_inner_error():
    t = _Traced()
    with pytest.raises(KeyError):
        with assert_no_retrace(t):
            t.trace_count += 5
            raise KeyError("inner failure wins")


def test_assert_no_retrace_misuse():
    with pytest.raises(ValueError, match="at least one target"):
        assert_no_retrace()
    guard = assert_no_retrace(_Traced())
    with pytest.raises(ValueError, match="not entered"):
        guard.new_traces
