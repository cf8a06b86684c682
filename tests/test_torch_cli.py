"""The port's CLI client against the JAX package's: the CLI half of
tests/test_config_cli.py. `validate_params` canonicalizes and rejects the
same values in both packages, the CLI refuses a bad value before any
network call, and the display tables render the same text. Tolerance:
exact. No JAX computation runs."""

import importlib

import pytest

JAX, PORT = "cruise_control_tpu", "cruise_control_torch"
PACKAGES = (JAX, PORT)


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


CANONICAL = [
    ("rebalance", {"dryrun": "Yes", "excluded_topics": "foo.*"},
     {"dryrun": "true", "excluded_topics": "foo.*"}),
    ("add_broker", {"brokerid": "3, 4"}, {"brokerid": "3,4"}),
    ("partition_load", {"resource": "nw_out", "entries": "07"},
     {"resource": "NW_OUT", "entries": "7"}),
    ("admin", {"enable_self_healing_for": "broker_failure, goal_violation"},
     {"enable_self_healing_for": "broker_failure,goal_violation"}),
    ("review", {"approve": "1,2", "reason": "ok"}, {"approve": "1,2", "reason": "ok"}),
]

REJECTED = [
    ("rebalance", {"dryrun": "maybe"}),
    ("rebalance", {"excluded_topics": "("}),  # invalid regex
    ("partition_load", {"entries": "-1"}),
    ("partition_load", {"resource": "GPU"}),
    ("admin", {"disable_self_healing_for": "nonsense"}),
    ("add_broker", {"brokerid": "a,b"}),
    ("state", {"bogus": "1"}),  # unknown parameter
    ("rebalance", {"bogus": "1"}),
]


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("endpoint,params,want", CANONICAL)
def test_validate_params_canonicalizes(pkg, endpoint, params, want):
    assert _m(pkg, "client.endpoint").validate_params(endpoint, params) == want


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("endpoint,params", REJECTED)
def test_validate_params_rejects(pkg, endpoint, params):
    with pytest.raises(ValueError) as got:
        _m(pkg, "client.endpoint").validate_params(endpoint, params)
    with pytest.raises(ValueError) as want:
        _m(JAX, "client.endpoint").validate_params(endpoint, params)
    assert str(got.value) == str(want.value)


def test_endpoint_tables_equal_jax():
    """Every endpoint's parameters and their types, and the CLI's endpoint
    sets, are the JAX client's."""
    port, jax_ = _m(PORT, "client.endpoint"), _m(JAX, "client.endpoint")
    assert {e: {n: type(p).__name__ for n, p in ps.items()}
            for e, ps in port.ENDPOINT_PARAMETERS.items()} == {
        e: {n: type(p).__name__ for n, p in ps.items()}
        for e, ps in jax_.ENDPOINT_PARAMETERS.items()}
    pc, jc = _m(PORT, "client.cccli"), _m(JAX, "client.cccli")
    assert (pc.GET_ENDPOINTS, pc.POST_ENDPOINTS) == (jc.GET_ENDPOINTS, jc.POST_ENDPOINTS)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_cli_rejects_bad_value_without_network(pkg, capsys):
    # client-side validation: no server at this address, yet the CLI fails fast
    rc = _m(pkg, "client.cccli").main(["-a", "http://127.0.0.1:1", "partition_load",
                                       "--entries", "-1"])
    assert rc == 2
    assert "invalid parameter" in capsys.readouterr().err


def test_display_tables():
    load = {
        "brokers": [
            {"Broker": 0, "Host": "host-0", "BrokerState": "ALIVE", "DiskMB": 1.0,
             "DiskPct": 0.1, "CpuPct": 5.0, "LeaderNwInRate": 1.0,
             "FollowerNwInRate": 1.0, "NwOutRate": 2.0, "PnwOutRate": 3.0,
             "Replicas": 7, "Leaders": 3}
        ],
        "hosts": [], "version": 1,
    }
    opt = {
        "summary": {"numReplicaMovements": 2},
        "goalSummary": [
            {"goal": "RackAwareGoal", "status": "FIXED",
             "clusterModelStats": {"violatedBrokersBefore": 1, "violatedBrokersAfter": 0}}
        ],
        "proposals": [{}, {}],
        "version": 1,
    }
    tasks = {"userTasks": [{"UserTaskId": "t", "RequestURL": "rebalance", "Status": "Active",
                            "StartMs": 1, "ClientIdentity": "127.0.0.1"}]}
    records = {"records": [{"topic": "t", "partition": 0, "leader": 1}]}
    cases = [("load", load), ("rebalance", opt), ("user_tasks", tasks),
             ("partition_load", records), ("partition_load", {"records": []}),
             ("state", {"errorMessage": "boom"}), ("state", {"a": 1})]
    port, jax_ = _m(PORT, "client.display"), _m(JAX, "client.display")
    for endpoint, payload in cases:
        assert port.render(endpoint, payload) == jax_.render(endpoint, payload)
    text = port.render("load", load)
    assert "Broker" in text and "host-0" in text and "ALIVE" in text
    text = port.render("rebalance", opt)
    assert "RackAwareGoal" in text and "FIXED" in text and "2 proposal(s)" in text
    assert port.render("state", {"errorMessage": "boom"}) == "ERROR: boom"
