"""The plain reference against the program at a tiny size on the CPU,
and the control: the reference in fp8 reads a wider gap than the
program's bf16 serving does."""
import dataclasses

import numpy as np
import pytest
import torch

from pbcore import testing
from pbcore.bench import verdict
from pbcore.reference import Reference, served_gap
from pbcore.serve import ServeRun, compared, program_config
from pbcore.weights import make_weights


def program_logits(spec, w, tokens):
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import DEFAULT_FLAGS
    # capacity for every pair of the call: the plain reference is dropless
    cfg = dataclasses.replace(program_config(spec), capacity_factor=64.0)
    model = Model(cfg, device="cpu", params=w)
    with torch.no_grad():
        logits, _, _ = model.forward(tokens[None], flags=DEFAULT_FLAGS)
    return logits[0, :, :spec["vocab_size"]].float()


@pytest.mark.parametrize("moe", [False, True])
def test_reference_is_the_program_in_f32(moe):
    spec = testing.spec(moe, dtype="float32")
    cfg = program_config(spec)
    w = make_weights(spec, 3, "cpu", vocab_rows=cfg.padded_vocab,
                     expert_rows=16 if moe else 0)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, 512, 40))
    ref = Reference(spec, w).logits(tokens, 0)
    got = program_logits(spec, w, tokens)
    scale = ref.abs().max()
    assert float((ref - got).abs().max()) < 1e-4 * float(scale)
    assert served_gap(ref, got.argmax(-1)).max() == 0.0


#: the widest gap a tiny configuration's check allows: its logits are a
#: few units wide, so the cells' limits do not carry over
TINY_LIMITS = {"logit_gap": 0.01}


@pytest.mark.parametrize("seed", [5, 2**31 + 9])
def test_control_reads_wider_than_the_program(seed):
    """The served run in bf16 against the fp8 control on the same
    prompts and served tokens, each judged by the verdict a run
    gives: the program's is correct, the control's is not."""
    run = ServeRun(testing.spec(), testing.mix(), seed, 1.0, False, "cpu")
    run.setup()
    run.window()
    run.close()
    reqs = run.sample()
    program = compared(run.gaps(reqs=reqs))
    control = compared(run.gaps("fp8", reqs=reqs))
    assert verdict(program, TINY_LIMITS)[0]
    assert not verdict(control, TINY_LIMITS)[0]
