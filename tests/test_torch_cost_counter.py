"""``roofline.analysis.step_costs``, the port's counterpart of the
reference's ``xla_costs``, on the CPU and the meta device: a matmul's
FLOPs and bytes, the meta count equal to the CPU count for a reduced
forward of every family, and the peak of live storages on known chains
(views and in-place results not counted twice)."""
import pytest
import torch

from repro_torch.config import get_config
from repro_torch.models.api import build_model
from repro_torch.roofline.analysis import step_costs

FAMILIES = ["smollm-360m", "granite-moe-1b-a400m", "internvl2-26b",
            "rwkv6-1.6b", "zamba2-2.7b", "whisper-tiny"]


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_one_matmul(device, lead):
    M, K, N = 8, 16, 4
    a = torch.ones(lead + (M, K), device=device)
    b = torch.ones((K, N), device=device)
    c = step_costs(lambda a, b: a @ b, a, b)
    batch = lead[0] if lead else 1
    assert c["flops"] == 2 * batch * M * N * K
    assert c["bytes"] == 4 * (batch * M * K + K * N + batch * M * N)
    assert c["collectives"] == {"total": 0.0}
    assert c["peak_memory"] == 4 * (batch * M * K + K * N + batch * M * N)


def _inputs(cfg, device, B=2, S=32):
    toks = torch.zeros((B, S), dtype=torch.int32, device=device)
    extra = None
    if cfg.family == "vlm":
        extra = torch.zeros((B, cfg.vision_tokens, cfg.d_model),
                            device=device)
        toks = toks[:, :S - cfg.vision_tokens]
    elif cfg.family == "audio":
        extra = torch.zeros((B, cfg.encoder_seq, cfg.d_model), device=device)
    return toks, extra


@pytest.mark.parametrize("arch", FAMILIES)
def test_meta_count_equals_the_cpu_count(arch):
    cfg = get_config(arch).reduced(dtype="float32")
    costs = {}
    for device in ("cpu", "meta"):
        model = build_model(cfg, device=device)
        params = model.init(0) if device == "cpu" else model.init_abstract()
        costs[device] = step_costs(
            lambda p, t, e: model.forward(p, t, e, last_only=True), params,
            *_inputs(cfg, device))
    assert costs["cpu"] == costs["meta"]
    assert costs["cpu"]["flops"] > 0 and costs["cpu"]["bytes"] > 0


def test_peak_of_a_chain():
    n = 1024 * 1024 * 4                 # 1024^2 float32
    x = torch.empty(1024, 1024, device="meta")

    def chain(x):
        for _ in range(10):
            x = x @ x + 1
        return x

    # the input, the value of x from the last round, x @ x and its + 1
    assert step_costs(chain, x)["peak_memory"] == 4 * n


def test_views_and_in_place_results_count_once():
    n = 256 * 256 * 4
    x = torch.empty(256, 256, device="meta")

    def views(x):
        y = x * 2                       # one new storage
        a, b = y.t(), y.view(-1)        # views of it: nothing new
        a.add_(1)                       # in place: nothing new
        return b.reshape(256, 256).sum()

    c = step_costs(views, x)
    assert c["peak_memory"] == 2 * n + 4       # x, y and the sum
    # the product reads x and writes y; add_ reads and writes y; the sum
    # reads y; the views move nothing
    assert c["bytes"] == 2 * n + 2 * n + n + 4


def test_a_dead_result_is_released():
    n = 512 * 512 * 4
    x = torch.empty(512, 512, device="meta")

    def rounds(x):
        for _ in range(5):
            y = x * 2
            del y
        return x.sum()

    assert step_costs(rounds, x)["peak_memory"] == 2 * n
