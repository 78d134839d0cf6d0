"""The demos of the port's ``launch.serve`` on the CPU at the smoke size: the
frontend trace, the churn demo, the chaos demo, the RPC demo and the
tenant demo each run to their end, where each asserts its own contract
(replies bitwise lone calls, live slots, typed errors, recovery of every
scripted fault, a graceful drain) and prints its summary."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve  # noqa: E402


@pytest.mark.parametrize("flags,expect", [
    (["--frontend", "--queries", "40"], "replies after the last burst bitwise lone calls"),
    (["--churn-demo", "--churn-ops", "60", "--queries", "4"], "churn OK"),
    (["--chaos-demo", "--queries", "24"], "chaos demo OK (cpu)"),
    (["--rpc", "--queries", "40", "--tenants", "3"], "graceful drain ok"),
    (["--tenant-demo", "--queries", "40", "--tenants", "3"], "checked bitwise"),
])
def test_serve_demo_runs_on_the_cpu(capsys, flags, expect):
    serve.main(["--device", "cpu", "--items", "200", *flags])
    out = capsys.readouterr().out
    assert expect in out, out


def test_serve_demos_need_the_corpus_engine():
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--engine", "percall", "--rpc"])
