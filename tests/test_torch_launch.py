"""The port's serving launcher (``python -m repro_torch.launch.serve``) on
the CPU: every mode of the JAX package's ``launch/serve.py`` runs to
exit code 0 on reduced granite_moe_3b_a800m (and the default
minicpm_2b), through ``--device cpu``, and so do ``--backend state`` on
reduced xlstm_1_3b and ``--backend hybrid`` on reduced
jamba_1_5_large_398b; an encoder-decoder is refused by the Scheduler,
as by the JAX launcher.  Every port ``GraphServer`` the
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


@pytest.mark.parametrize("extra", [
    ["--arch", "xlstm_1_3b", "--backend", "state"],
    ["--arch", "xlstm_1_3b", "--backend", "state", "--speculate", "2",
     "--chunk-size", "8", "--frontend", "async"],
    ["--arch", "jamba_1_5_large_398b", "--backend", "hybrid"],
    ["--arch", "jamba_1_5_large_398b", "--backend", "hybrid",
     "--speculate", "2", "--chunk-size", "16", "--frontend", "async"],
], ids=["xlstm_state", "xlstm_state_spec_async", "jamba_hybrid",
        "jamba_hybrid_spec_async"])
def test_state_layouts_exit_zero(extra, capsys):
    assert serve.main(BASE + extra) == 0
    out = capsys.readouterr().out
    if "--frontend" in extra:
        assert "async: streamed 16 tokens from 4 requests" in out
    else:
        assert "served 4/4 requests" in out
        assert "state slabs: peak_in_use=2 in_use=0" in out


def test_unported_backend_raises_naming_its_item():
    """The state and hybrid layouts are served since ROADMAP Queue 1
    item 7.  An encoder-decoder (seamless_m4t_large_v2, served by
    ``generate`` since item 9) is refused by the Scheduler inside the
    server's graph, as by the JAX launcher; a hybrid arena whose block
    size does not divide the engine's ``max_len`` is refused inside the
    server's graph too.  Each run fails with the refusal."""
    with pytest.raises(GraphError, match="continuous batching supports "
                                         "decoder-only models"):
        serve.main(BASE + ["--arch", "seamless_m4t_large_v2", "--backend",
                           "state"])
    with pytest.raises(GraphError, match="multiple of block_size"):
        serve.main(BASE + ["--arch", "jamba_1_5_large_398b", "--backend",
                           "hybrid", "--block-size", "24"])


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
