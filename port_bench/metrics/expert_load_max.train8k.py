"""How far the busiest held expert runs above the held experts' mean
load, a MoE layer a step, over the traced stretch: the model's
`moe_load_max` (the busiest held expert's routes, summed over layers and
steps) over its mean held load (`moe_held_routes` over `moe_layer_steps`
x the experts held).  1 is an even load; the grouped product waits on
the busiest.  The model-step layer; moves train_step_ms.  None without
the counters."""


def read(obs):
    c = obs.get("counters")
    if not c or not c.get("moe_held_routes"):
        return None
    held = obs["model"]["n_routed_experts"]
    return c["moe_load_max"] * held / c["moe_held_routes"]
