"""The decode attention's share of its roofline in the traced replays, in
%: the sum over the traced steps of the attention's least time (the larger
of its operations over the bf16 peak and its bytes over the memory rate)
over the sum of their device times in ``repro_torch.attend`` spans
(``decode_attn_ms``'s intervals and replays).  A step of B rows at kv cached positions
attends over kv + 1 in each of L layers: 4 * B * H * hd * (kv + 1)
operations a layer; bytes count each input once, the live K and V and q,
and the output written, in bf16."""

from portbench import spans
from portbench.reference import counts


def attend(model: dict, B: int, kv: int) -> tuple[float, float]:
    """(operations, bytes) of the attention of one decode step."""
    L, H, KV = model["num_layers"], model["num_heads"], model["num_kv_heads"]
    hd = model.get("head_dim") or model["d_model"] // H
    flops = 4.0 * B * H * hd * L * (kv + 1)
    nbytes = counts.BF16 * L * B * hd * (2 * (kv + 1) * KV + 2 * H)
    return flops, float(nbytes)


def read(run):
    steps = spans.decode_steps(run, "decode_attn_roofline")
    if not steps:
        return None
    least = sum(counts.least_seconds(*attend(run.model, B, kv))
                for _, (B, kv), _ in steps)
    return 100.0 * least / sum(r.get("attend", 0.0) for _, _, r in steps)
