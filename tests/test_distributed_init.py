"""parallel.distributed.initialize: which card each same-host rank takes."""

import pytest

from rkmh_tpu.parallel import distributed


@pytest.fixture
def captured(monkeypatch):
    seen = {}
    monkeypatch.setattr(distributed.jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                "JAX_PROCESS_ID", "JAX_LOCAL_DEVICE_IDS"):
        monkeypatch.delenv(var, raising=False)
    return seen


@pytest.mark.parametrize("addr,rank,want", [
    ("localhost:4321", 2, [2]),      # one host, four cards: rank -> card
    ("127.0.0.1:4321", 0, [0]),
    ("[::1]:4321", 3, [3]),
    ("node7.cluster:4321", 1, None),  # ranks on other hosts: JAX decides
])
def test_same_host_ranks_take_their_own_card(captured, addr, rank, want):
    distributed.initialize(addr, 4, rank)
    assert captured["local_device_ids"] == want
    assert captured["process_id"] == rank and captured["num_processes"] == 4


def test_env_override_wins(captured, monkeypatch):
    monkeypatch.setenv("JAX_LOCAL_DEVICE_IDS", "0,1")
    distributed.initialize("localhost:4321", 2, 1)
    assert captured["local_device_ids"] is None  # JAX reads the variable


def test_single_process_is_a_no_op(captured):
    distributed.initialize(None, 1, None)
    assert captured == {}
