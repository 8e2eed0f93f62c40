"""The port's serving launcher (``python -m repro_torch.launch.serve``) on
the CPU: every mode of the JAX package's ``launch/serve.py`` runs to
exit code 0 on reduced granite_moe_3b_a800m (and the default
minicpm_2b), through ``--device cpu``; a layout the port has not ported
raises, naming its ROADMAP item.  Every port ``GraphServer`` the
launcher closes passes the leak check imported from
``test_torch_graph.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import GraphError  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from test_torch_engine import one_torch_thread  # noqa: E402,F401
from test_torch_graph import graphserver_leak_check  # noqa: E402,F401

BASE = ["--device", "cpu", "--arch", "granite_moe_3b_a800m", "--requests",
        "4", "--clients", "2", "--max-new-tokens", "4"]


@pytest.mark.parametrize("extra", [[], ["--paged"], ["--frontend", "async"],
                                   ["--fixed-batch"],
                                   ["--arch", "minicpm_2b"]],
                         ids=["continuous", "paged", "async", "fixed_batch",
                              "minicpm_2b"])
def test_launcher_modes_exit_zero(extra, capsys):
    assert serve.main(BASE + extra) == 0
    out = capsys.readouterr().out
    if "--frontend" in extra:
        assert "async: streamed 16 tokens from 4 requests" in out
    else:
        assert "served 4/4 requests" in out


def test_unported_backend_raises_naming_its_item():
    """The engine refuses the state layout inside the server's graph,
    whose run fails with the engine's error."""
    with pytest.raises(GraphError, match="ROADMAP Queue 1 item 7"):
        serve.main(BASE + ["--backend", "state"])


def test_reduced_flag_turns_off(monkeypatch):
    """``--no-reduced`` builds the configuration at full width (the
    engine is stopped before it allocates), ``--reduced`` the default."""
    built = []

    class Stop(Exception):
        pass

    def engine(cfg, **kw):
        built.append((cfg, kw))
        raise Stop

    monkeypatch.setattr(serve, "LLMEngine", engine)
    for flag, layers in (("--no-reduced", 32), ("--reduced", 2), (None, 2)):
        with pytest.raises(Stop):
            serve.main(BASE + ([flag] if flag else []))
        cfg, kw = built[-1]
        assert cfg.num_layers == layers and kw["device"] == "cpu"
    assert built[0][0].d_model == 1536
