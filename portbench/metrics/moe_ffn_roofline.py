"""One layer's MoE FFN of the program timed alone after the window at the
cell's decode rows (its slots), against its bound: the router's and the
reached experts' weights and the activations, each read once."""
from pbcore import costs, kerneltime


def read(run):
    if not run.spec.get("num_local_experts"):
        return None
    ms, flops, nbytes = kerneltime.moe_layer(
        run.spec, run.cfg, run.weights, int(run.mix["slots"]), run.device)
    return costs.roofline_pct(flops, nbytes, ms / 1e3)
