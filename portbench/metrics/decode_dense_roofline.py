"""The decode layers' own work's share of its roofline in the traced
replays that ``decode_attn_ms`` reads, in %: the sum over those steps of
its least time over the sum of the self time of their ``repro_torch.layer``
spans (the norms, Q, K, V, the K/V row's write, O and the MLP; the
attention inside is its own span).  The work of a step of B rows: each
layer's weights and vectors read once and its new K/V row written, in
bf16, and 2 * B operations a matmul weight.  Also prints, for the log, how
much of each replay's device time (``decode_step_ms``'s intervals) the
layers' spans cover, and each replay's ms in ``attend`` and in the layers'
own work."""

import sys

from portbench import spans
from portbench.reference import counts


def layers(model: dict, B: int) -> tuple[float, float]:
    """(operations, bytes) of the layers' own work in one decode step."""
    L, H, KV = model["num_layers"], model["num_heads"], model["num_kv_heads"]
    hd = model.get("head_dim") or model["d_model"] // H
    matmul = counts.layer_matmul_params(model)
    weights = L * (matmul + counts.layer_vector_params(model))
    return 2.0 * B * L * matmul, float(counts.BF16 * (weights + 2 * L * B * KV * hd))


def read(run):
    steps = spans.decode_steps(run, "decode_dense_roofline")
    if not steps:
        return None
    device = run.trace.spans.get("portbench.decode_step", [])
    if len(device) == len(run.stretch.decodes):
        cover = sorted((r.get("layer", 0.0) + r.get("attend", 0.0)) / device[i]
                       for i, _, r in steps)
        print(f"decode_dense_roofline: layer spans cover {100 * cover[0]:.2f}-"
              f"{100 * cover[-1]:.2f}% of the device time of each of "
              f"{len(steps)} replays of {spans.node_map().nodes} nodes",
              file=sys.stderr)
    print("decode_dense_roofline: replays' attend / layer ms "
          + " ".join(f"{1e3 * r.get('attend', 0.0):.3f}/{1e3 * r.get('layer', 0.0):.3f}"
                     for _, _, r in steps), file=sys.stderr)
    least = sum(counts.least_seconds(*layers(run.model, B)) for _, (B, _), _ in steps)
    return 100.0 * least / sum(r.get("layer", 0.0) for _, _, r in steps)
