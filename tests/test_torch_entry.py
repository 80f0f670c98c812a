"""The port's entry points (``infera_tpu_torch/entry.py``) on the CPU.

``dryrun_multichip`` runs every parallel form with the reference's asserts
to its end, on 8 logical shards (meshes (8, 1) and (4, 2)), on 4, and on 1
(section 1 only, as in the reference); ``entry()``'s forward step equals
``__graft_entry__.entry()``'s on the same 1,024 rows at 1e-5 (f32 products
in another order).
"""

import numpy as np
import pytest
import torch

import infera_tpu_torch as itt
from infera_tpu_torch import entry as E


@pytest.fixture()
def on_cpu():
    itt.set_device("cpu")
    yield
    itt.set_device(None)


@pytest.mark.parametrize("n", [8, 4, 1])
def test_dryrun_multichip_runs_to_its_end(n, on_cpu):
    E.dryrun_multichip(n)


def test_dryrun_leaves_the_device_choice_as_it_was():
    itt.set_device(None)
    E.dryrun_multichip(2, device="cpu")
    from infera_tpu_torch import device as D

    assert D._device is None


def test_entry_matches_graft_entry(on_cpu):
    import __graft_entry__ as ref

    fn, (x,) = E.entry()
    rfn, (rx,) = ref.entry()
    assert x.device == torch.device("cpu") and x.shape == (1024, 32)
    np.testing.assert_array_equal(x.numpy(), np.asarray(rx))
    got, want = fn(x).numpy(), np.asarray(rfn(rx))
    assert got.shape == (1024, 16)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_main_prints_a_pass(capsys, on_cpu):
    E.main(["2", "--cpu"])
    assert capsys.readouterr().out.strip() == "dryrun_multichip(2) passed"
