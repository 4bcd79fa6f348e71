"""`utils.capture.CapturedRun` (n sweeps as one program on static state
tensors) against the eager sweeps, bit for bit: they make the same calls.
On the CPU the steps run eagerly; on a card (`cuda`, skipped elsewhere) the
captured graph's replays.  This file imports no JAX, so the card's machine
runs it (README)."""
import pytest
import torch

from gbp_tpu_torch.bench import CFG
from gbp_tpu_torch.core import sweep_cm
from gbp_tpu_torch.models import ba
from gbp_tpu_torch.utils.capture import CapturedRun, tensors, write_back

torch.set_num_threads(1)
SCENE = dict(n_cams=8, n_lmks=200, pix_sigma=1.0, seed=0)


def _bench_problem(device):
    graph, means = ba.build(ba.simulate(**SCENE), device=device)
    cmg = sweep_cm.prepare(graph, segsum_exact=True)
    return cmg, sweep_cm.init_state(cmg, means)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(tensors(a), tensors(b)))


def test_captured_run_on_cpu_equals_sweep_cm_run():
    cmg, init = _bench_problem("cpu")
    run = CapturedRun(lambda s: sweep_cm.sweep(cmg, s, CFG), init, 5)
    assert not run.on_card
    for _ in range(3):
        state = run()
    assert state is run.state and _same(state, sweep_cm.run(cmg, init, CFG, 15))
    assert _same(run.load(init), init) and _same(run(), sweep_cm.run(cmg, init, CFG, 5))


def test_write_back_clones_a_source_that_aliases_another_target():
    a, b = torch.arange(3.0), torch.arange(3.0, 6.0)
    write_back((a, b), (b, a))  # a swap: each source is the other target
    assert a.tolist() == [3.0, 4.0, 5.0] and b.tolist() == [0.0, 1.0, 2.0]


@pytest.mark.cuda
def test_captured_run_equals_eager_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cmg, init = _bench_problem(torch.device("cuda"))
    run = CapturedRun(lambda s: sweep_cm.sweep(cmg, s, CFG), init, 5)
    for _ in range(4):
        run()
    assert run.on_card and run.graph is not None
    assert _same(run.state, sweep_cm.run(cmg, init, CFG, 20))
