"""The grouped expert products' share of their operations bound, in
percent: each route to a held expert in the traced stretch (the model's
`moe_held_routes`) takes three matrices of hidden x
moe_intermediate_size, forward and twice in the backward, at the card's
bf16 peak, over the device time of the grouped GEMM kernels (CUTLASS's
GroupProblemShape kernels and their argument set-up,
prepare_grouped_gemm_data).  The kernels layer; moves train_step_ms.
None without the counters or the kernels."""

from port_bench.reference import counts, counts_moonlight

KERNELS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def read(obs):
    c = obs.get("counters")
    if not c or "moe_held_routes" not in c:
        return None
    ops = 3 * c["moe_held_routes"] * counts_moonlight.expert_route_flops(
        obs["model"])
    t = sum(x for _, x in obs["trace"].kernels(*KERNELS))
    return counts.share(ops, counts.PEAK_BF16_FLOPS, t)
