"""The plain reference and the yardstick of work.

The reference is held to the program's own CPU path at a tiny size of both
configurations, in float32, where the two must agree to rounding; the
counts are held to hand counts at one shape and to the flash bounds
``PERF.md`` gives at G 5 and G 9.  This test may import the program; the
reference may not (``test_portbench_imports.py``).
"""

import pytest
import torch

from conftest import tiny_config
from portbench import serving, weights
from portbench.reference import counts, decoder


@pytest.mark.parametrize("arch", ["starcoder2_7b", "qwen2p5_14b"])
def test_reference_matches_the_port_in_float32(arch):
    from repro_torch.models import transformer as TF
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import abstract_init

    config = tiny_config(arch)
    api = build_model(serving.port_config(config), "cpu")
    w = weights.make(abstract_init(api)[0], 5, torch.device("cpu"))
    w32 = _float(w)
    tokens = torch.randint(0, 512, (2, 24), generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        got, _ = TF.lm_forward(w32, api.cfg, tokens, remat=False)
        want = decoder.logits_at(w, config["model"], tokens, torch.arange(24))
    assert want.shape == got.shape == (2, 24, 512)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def _float(tree):
    if isinstance(tree, dict):
        return {k: _float(v) for k, v in tree.items()}
    return tree.float()


@pytest.mark.parametrize("arch", ["starcoder2_7b", "qwen2p5_14b"])
def test_every_weight_reaches_the_logits(arch):
    """A change to any leaf moves the reference's logits: none is unread."""
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import abstract_init

    config = tiny_config(arch)
    api = build_model(serving.port_config(config), "cpu")
    w = weights.make(abstract_init(api)[0], 7, torch.device("cpu"))
    tokens = torch.randint(0, 512, (1, 12), generator=torch.Generator().manual_seed(1))
    wanted = torch.arange(12)
    base = decoder.logits_at(w, config["model"], tokens, wanted)
    for path, leaf in _leaves(w):
        saved = leaf.clone()
        leaf.add_(0.5)
        moved = (decoder.logits_at(w, config["model"], tokens, wanted) - base).abs().max()
        leaf.copy_(saved)
        assert moved > 1e-3, path


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def test_float8_control_rounds_each_column_to_e4m3():
    w = torch.randn(64, 8, generator=torch.Generator().manual_seed(2))
    q = decoder.fp8_weights(w)
    assert torch.allclose(q.abs().amax(0), w.abs().amax(0), rtol=1e-6)
    rel = ((q - w).abs() / w.abs().amax(0)).max().item()
    assert 2.0**-9 < rel <= 2.0**-4     # coarser than bf16, within e4m3's step


MODEL = {"num_layers": 2, "d_model": 128, "num_heads": 4, "num_kv_heads": 1,
         "head_dim": 32, "d_ff": 256, "vocab_size": 512, "mlp": "gelu",
         "norm": "ln", "qkv_bias": True}


def test_counts_against_hand_counts():
    # one layer's products: Q 128x128, K and V 128x32 each, O 128x128, MLP 2x 128x256
    assert counts.layer_matmul_params(MODEL) == 106_496
    # two LayerNorms (w, b) and the Q/K/V biases
    assert counts.layer_vector_params(MODEL) == 704
    flops, nbytes = counts.decode_step(MODEL, B=2, kv_len=10)
    # 2 x 2 rows x (2 layers + the unembedding); 4 x B x H x hd x L x 11 positions
    assert flops == 2 * 2 * (2 * 106_496 + 128 * 512) + 4 * 2 * 4 * 32 * 2 * 11
    weights_b = 2 * (2 * (106_496 + 704) + 128 * 512 + 128 + 2 * 128)
    kv = 2 * 2 * 2 * 2 * 10 * 32 + 2 * 2 * 2 * 2 * 32
    assert nbytes == weights_b + kv + 2 * 2 * 512
    # 36 causal pairs of 8 positions
    assert counts.prefill_flops(MODEL, B=2, S=8) == (
        2 * 2 * 8 * 2 * 106_496 + 4 * 2 * 4 * 32 * 2 * 36 + 2 * 2 * 128 * 512)
    assert counts.flash_call(2, 8, 8, 4, 1, 32) == (4 * 2 * 4 * 32 * 36,
                                                   2 * 2 * 32 * (2 * 8 * 4 + 2 * 8))
    assert counts.flash_pairs(4, 10, True, 6) == 7 + 8 + 9 + 10


@pytest.mark.parametrize("Hq, Hkv, bound_ms", [(40, 8, 0.0300), (36, 4, 0.0250)])
def test_flash_bounds_match_the_records(Hq, Hkv, bound_ms):
    """PERF.md's kernel table: flash at B 8, S 512, causal, D 128 is bound
    by bytes at 0.0300 ms (G 5) and 0.0250 ms (G 9)."""
    flops, nbytes = counts.flash_call(8, 512, 512, Hq, Hkv, 128)
    assert nbytes / counts.HBM_BYTES_PER_S > flops / counts.PEAK_BF16_FLOPS
    assert round(counts.least_seconds(flops, nbytes) * 1e3, 4) == bound_ms


class _Event:
    def __init__(self, name, device, start, end, annotation=False, corr=0, linked=0):
        self._v = (name, device, start, end, annotation, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._v[1] else DeviceType.CPU

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def is_user_annotation(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]


class _Profile:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": lambda _: events})()})()


def test_trace_reads_busy_as_a_union_and_names_the_gaps():
    from portbench import trace

    ms = 1_000_000
    events = [
        _Event("portbench.traced", False, 0, 100 * ms),
        _Event("portbench.traced", True, 0, 100 * ms, annotation=True),
        _Event("portbench.decode_step", False, 10 * ms, 60 * ms, corr=7),
        _Event("cudaGraphLaunch", False, 40 * ms, 60 * ms, corr=70, linked=7),
        _Event("gemm", True, 0, 30 * ms, linked=7),
        _Event("gemm", True, 20 * ms, 40 * ms, linked=7),   # overlaps: counted once
        _Event("softmax", True, 70 * ms, 120 * ms),    # clipped at the end
    ]
    t = trace.read(_Profile(events))
    assert t.window_s == 0.1
    assert abs(t.busy_s - 0.07) < 1e-12                # 0-40 and 70-100
    assert t.device_ops == [["gemm", 0.05], ["softmax", 0.03]]
    assert t.idle_gaps == [["portbench.decode_step > cudaGraphLaunch", 0.03]]
    assert t.spans == {"portbench.decode_step": [0.04]}
    assert trace.union_seconds([(0, 2), (1, 3), (5, 6)]) == 4
