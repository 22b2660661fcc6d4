"""Departure 16 on the reference's evidence: a trial chaotic in rounding.

Table 6's reduced FedAdam trial (speech_command, preference 14, batch 10,
512 eval points, seed 0; ``launch/paper_tables.build_sweep``) runs from
the port's own init, as ``chip_smoke.py`` phase 16a runs it, for 4 rounds
in both packages, in the reference from that init moved one ulp up and
one ulp down, and, through ``twin_drift.Recorder``, from states handed
over between the packages.  Measured here (``tests/twin_drift.py``):

  * (M, E) and the costs are equal in every run;
  * after rounds 1-3 the port's largest |param difference| from the
    reference is at most ``TWIN_GAP_MULTIPLE`` times the larger of the
    reference twins' (1.19e-6, 8.73e-6, 1.15e-4 against 1.19e-6, 1.63e-5,
    2.13e-4);
  * each port round run from the reference's own state after the round
    before lands within ``TWIN_GAP_MULTIPLE`` times the reference's
    response to that state moved one ulp (1.19e-6, 5.77e-6, 3.56e-5,
    4.36e-5 against 1.19e-6, 6.41e-6, 2.06e-5, 6.13e-5);
  * round 4, where the port's run crosses a ReLU kink the reference's
    does not (0.12 apart, 164x its twins): the reference run from the
    port's state after round 3 lands 9.5e-6 from the port's round 4, and
    the port run from the reference's lands 4.4e-5 from the reference's.

And the adaptive server steps themselves are the reference's bit for bit
on the same inputs, so that drift comes from local training's last bits
(matrix products summed in another order), not from the server.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import twin_drift as td  # noqa: E402
from repro.federated import aggregation as jagg  # noqa: E402
from repro_torch.federated import aggregation as tagg  # noqa: E402

ROUNDS = 4
TWIN_GAP_MULTIPLE = 2.0        # chip_smoke.py phase 16a's
HANDOVER = 1e-4                # a round from the other package's state


@pytest.fixture(scope="module")
def runs():
    spec = td.table6_spec("fedadam", 0, ROUNDS)
    init = td.port_init(spec)
    ref = td.run_trial(spec, init, "ref")
    port = td.run_trial(spec, init, "port")
    return dict(
        ref=ref, port=port,
        twins=[td.run_trial(spec, td.moved(init, tw), "ref")
               for tw in td.TWINS],
        port_fresh=td.run_trial(spec, init, "port",
                                td.reset_to(ref["states"])),
        ref_fresh_twins=[td.run_trial(spec, td.moved(init, tw), "ref",
                                      td.reset_to(ref["states"], tw))
                         for tw in td.TWINS],
        swap=td.run_trial(spec, init, "ref",
                          {ROUNDS - 1: port["states"][ROUNDS - 2]}))


def test_port_drifts_from_the_reference_within_its_own_twins(runs):
    ref, port, twins = runs["ref"], runs["port"], runs["twins"]
    for other in [port] + twins:
        assert other["m_e"] == ref["m_e"]
        assert other["costs"] == ref["costs"]
    assert len(ref["states"]) == len(port["states"]) == ROUNDS
    for r in range(ROUNDS - 1):
        drift = td.max_diff(port["states"][r][0], ref["states"][r][0])
        spread = max(td.max_diff(t["states"][r][0], ref["states"][r][0])
                     for t in twins)
        assert 0.0 < spread, f"round {r + 1}: the twins did not move"
        assert drift <= TWIN_GAP_MULTIPLE * spread, (
            f"round {r + 1}: the port drifted {drift} from the reference, "
            f"its one-ulp twins at most {spread}")


def test_each_port_round_stays_within_twice_a_one_ulp_moves_response(runs):
    """The port's own error, round by round: a port round from the
    reference's state against the reference's response to that state
    moved one ulp."""
    fresh = td.fresh_errors(runs["ref"], runs["port_fresh"],
                            runs["ref_fresh_twins"])
    assert len(fresh) == ROUNDS
    for r, (err, resp, _) in enumerate(fresh):
        assert 0.0 < resp, f"round {r + 1}: the one-ulp moves did nothing"
        assert err <= TWIN_GAP_MULTIPLE * resp, (
            f"round {r + 1}: the port's round from the reference's state "
            f"is {err} from the reference's, a one-ulp move {resp}")


def test_the_reference_from_the_ports_state_takes_the_ports_round(runs):
    """Round 4 from the other package's state after round 3: each package
    lands where the other would, whether or not the whole runs part."""
    last = ROUNDS - 1
    ref, port = runs["ref"], runs["port"]
    assert runs["swap"]["m_e"] == ref["m_e"]
    assert td.max_diff(runs["swap"]["states"][last][0],
                       port["states"][last][0]) <= HANDOVER
    assert td.max_diff(runs["port_fresh"]["states"][last][0],
                       ref["states"][last][0]) <= HANDOVER


@pytest.mark.parametrize("name", ["fedadam", "fedyogi", "fedadagrad"])
def test_adaptive_server_steps_are_the_references_bit_for_bit(name):
    """Six steps on the same updates, the moments carried: the same bits,
    deltas from 1e-6 to 1e-1 (FedAdam's step normalises each one)."""
    rng = np.random.default_rng(6)
    shapes = {"b0": (48,), "w0": (64, 48), "b1": (35,), "w1": (48, 35)}
    g = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
         for k, s in shapes.items()}
    ja, ta = jagg.get_aggregator(name), tagg.get_aggregator(name)
    jg = jax.tree.map(jnp.asarray, g)
    tg = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
    for _ in range(6):
        ups = []
        for c in range(5):
            scale = np.float32(10.0 ** rng.uniform(-6, -1))
            ups.append(({k: (v + rng.standard_normal(v.shape).astype(
                np.float32) * scale).astype(np.float32)
                for k, v in g.items()}, int(rng.integers(10, 300))))
        jg = ja(jg, [jagg.ClientUpdate(params=jax.tree.map(jnp.asarray, p),
                                       n_examples=n, n_steps=3)
                     for p, n in ups])
        tg = ta(tg, [tagg.ClientUpdate(
            params={k: torch.from_numpy(v.copy()) for k, v in p.items()},
            n_examples=n, n_steps=3) for p, n in ups])
        for k in shapes:
            np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))
        g = {k: np.asarray(jg[k]) for k in shapes}
