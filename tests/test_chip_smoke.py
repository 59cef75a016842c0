"""chip_smoke.py and bench.py without a card: the device checks refuse the
CPU, and phase (b)'s bit-exact kernel parity runs at ring 2048.  The same
parity at production width is marked `gpu` and runs on the card."""

import jax
import pytest

import bench
import chip_smoke


def test_device_check_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.check_device(jax.devices())


def test_bench_refuses_cpu_unless_rehearsal(monkeypatch, capsys):
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    assert bench.main() == 2
    out = capsys.readouterr()
    assert out.out == ""  # no result line
    assert "no GPU found" in out.err


def test_kernel_parity_ring2048():
    ctx = chip_smoke.make_context(5, ring=2048)
    res = chip_smoke.kernel_parity(ctx, batch=16)
    assert res["ring"] == 2048 and res["limbs"] == ctx.Ltot
    assert res["ct_dot_memory"]["output_size_in_bytes"] == 3 * ctx.Lq * 2048 * 4


@pytest.mark.gpu
def test_kernel_parity_production(gpu_device):
    res = chip_smoke.kernel_parity(chip_smoke.make_context(5))
    assert res["ring"] == 32768 and res["batch"] == chip_smoke.BATCH
