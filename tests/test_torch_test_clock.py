"""``tests/port_test_clock.py``: ``--queue``, the order in which the suite's
``--dist loadfile`` hands out its files, held to xdist's own scheduler on a
synthetic collection; ``--junit``, a run's S, T and F replayed from its
test times."""

import json
from collections import OrderedDict
from types import SimpleNamespace

import pytest

from tests import port_test_clock as clock

# a synthetic collection: files of 3, 1, 3, 2 and 5 tests, in collection order
COLLECTION = ([f"tests/test_a.py::t{i}" for i in range(3)] + ["tests/test_b.py::t0"]
              + [f"tests/test_c.py::t[{i}::x]" for i in range(3)]
              + [f"tests/test_d.py::T::t{i}" for i in range(2)]
              + [f"tests/test_e.py::t{i}" for i in range(5)])
ORDER = ["tests/test_e.py", "tests/test_a.py", "tests/test_c.py", "tests/test_d.py",
         "tests/test_b.py"]


def test_nodeids_are_counted_by_file_in_collection_order():
    lines = [*COLLECTION, "", "14 tests collected in 0.01s"]
    assert clock.count_nodeids(lines) == [("tests/test_a.py", 3), ("tests/test_b.py", 1),
                                          ("tests/test_c.py", 3), ("tests/test_d.py", 2),
                                          ("tests/test_e.py", 5)]


def test_loadfile_order_puts_more_tests_first_and_keeps_ties_in_collection_order():
    order = clock.loadfile_order(clock.count_nodeids(COLLECTION))
    assert [f for f, _ in order] == ORDER
    assert [n for _, n in order] == [5, 3, 3, 2, 1]


class _Node:
    shutting_down = False

    def __init__(self):
        self.sent = []

    def send_runtest_some(self, indexes):
        self.sent.append(indexes)

    def shutdown(self):
        self.shutting_down = True


def test_loadfile_order_is_the_order_xdist_schedules():
    """xdist's ``LoadFileScheduling`` on the same collection with one node:
    the unit it assigns first, then its queue, is ``loadfile_order``."""
    loadfile = pytest.importorskip("xdist.scheduler.loadfile")
    from xdist.remote import Producer

    sched = loadfile.LoadFileScheduling.__new__(loadfile.LoadFileScheduling)
    sched.numnodes, sched.collection = 1, None
    sched.workqueue, sched.assigned_work, sched.registered_collections = OrderedDict(), {}, {}
    sched.log = Producer("loadfilesched", enabled=False)
    sched.config = SimpleNamespace(option=SimpleNamespace(loadscopereorder=True))
    node = _Node()
    sched.add_node(node)
    sched.add_node_collection(node, COLLECTION)
    sched.schedule()
    first = [COLLECTION[i].split("::", 1)[0] for i in node.sent[0]]
    assert set(first) == {ORDER[0]} and len(first) == 5
    assert list(sched.workqueue) == ORDER[1:]


@pytest.mark.parametrize("form", ["measure", "pair"])
def test_cpu_seconds_are_read_from_either_form_of_out(tmp_path, form):
    rows = [{"file": "tests/test_a.py", "cpu_s": 1.5}, {"file": "tests/test_b.py", "cpu_s": 2.0}]
    data = ({"total_cpu_s": 3.5, "files": rows} if form == "measure" else
            [{"file": r["file"], "this": r, "other": {**r, "cpu_s": 9.0}} for r in rows])
    path = tmp_path / "clock.json"
    path.write_text(json.dumps(data))
    assert clock._cpu_by_file(str(path)) == {"tests/test_a.py": 1.5, "tests/test_b.py": 2.0}


JUNIT = """<?xml version="1.0" encoding="utf-8"?><testsuites><testsuite name="pytest" tests="13">
{}
</testsuite></testsuites>"""


def test_a_junit_replays_into_s_t_and_f(tmp_path):
    """Two workers. a (20, 1, 1, 1) and b (1, 1, 1) go out first; b's
    worker takes the critical c (1, 1, 10) after b's first test, starts it
    at 3 s, and takes d (5) and e (1) while c's last two tests are pending:
    F is both, 6 s, which run after c's 10 s test."""
    times = {"a": [20, 1, 1, 1], "b": [1, 1, 1], "c": [1, 1, 10], "d": [5], "e": [1]}
    cases = [f'<testcase classname="tests.test_{f}" name="t{i}" time="{t}" />'
             for f, ts in times.items() for i, t in enumerate(ts)]
    cases.insert(7, '<testcase classname="tests.test_b.TestK" name="x" time="0" />')
    path = tmp_path / "run.xml"
    path.write_text(JUNIT.format("".join(cases)))
    got = clock.junit_times(str(path))
    assert got["tests/test_b.py"] == [1, 1, 1, 0.0] and got["tests/test_c.py"] == [1, 1, 10]
    del got["tests/test_b.py"][3]
    r = clock.replay(got, workers=2, critical="tests/test_c.py")
    assert (r["S"], r["T"]) == (3.0, 12.0)
    assert r["F"] == (["tests/test_d.py", "tests/test_e.py"], 6.0)
    assert r["end"] == 23.0
    assert r["files"]["tests/test_e.py"] == {"worker": 1, "start": 20.0, "end": 21.0}
