"""The port's root examples (``src/repro_torch/examples``) on the CPU: each
runs to its end with ``--device cpu`` and passes its own checks (the loss
falls and tokens come out in range; sampled tokens of the batch's shape;
a resumed run within 5 % of the uninterrupted one)."""
import pytest
import torch

from repro_torch.examples import elastic_restart, quickstart, serve_batched


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's workers share the machine's cores,
    and these small models gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart():
    history, out = quickstart.main(["--device", "cpu"])
    assert len(history) == 60 and tuple(out.shape) == (4, 8)


def test_serve_batched():
    out = serve_batched.main(["--device", "cpu", "--batch", "4",
                              "--steps", "8"])
    assert tuple(out.shape) == (4, 8)


def test_elastic_restart(tmp_path):
    resumed, straight = elastic_restart.main(
        ["--device", "cpu", "--ckpt", str(tmp_path / "ckpt")])
    assert abs(resumed - straight) / straight < 0.05
