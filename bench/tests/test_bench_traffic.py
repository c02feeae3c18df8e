"""The generator: every seed gets the same multiset of prompt lengths in
another order, whole rounds hold one length of every stratum, and the
same seed gives the same tokens."""
import itertools
import json

import torch

from harness import manifest
from harness.traffic import Tokens, length_schedule, prompt_lengths

PREFILL = json.loads((manifest.BENCH / "traffic" / "grouped_prefill.json")
                     .read_text())["prompt"]


def test_lengths_are_the_stratified_lognormal():
    ls = prompt_lengths(PREFILL)
    assert len(ls) == 64 and ls == sorted(ls)
    assert ls[0] == 128 and ls[-1] == 4096
    assert ls[31] <= 1024 <= ls[32]


def test_every_seed_has_the_same_lengths_in_another_order():
    cycles = [list(itertools.islice(length_schedule(PREFILL, s), 64))
              for s in (1, 2 ** 31 + 9)]
    assert sorted(cycles[0]) == sorted(cycles[1]) == prompt_lengths(PREFILL)
    assert cycles[0] != cycles[1]


def test_each_round_holds_one_length_of_every_stratum():
    ls = prompt_lengths(PREFILL)
    strata = [ls[4 * i:4 * i + 4] for i in range(16)]
    sched = list(itertools.islice(length_schedule(PREFILL, 77), 64))
    for r in range(4):
        rnd = sorted(sched[16 * r:16 * r + 16])
        assert all(s[0] <= x <= s[-1] for x, s in zip(rnd, strata))


def test_tokens_repeat_by_seed():
    a = Tokens(1000, 2 ** 31 + 1, "cpu").draw(2, 8)
    b = Tokens(1000, 2 ** 31 + 1, "cpu").draw(2, 8)
    c = Tokens(1000, 2 ** 31 + 2, "cpu").draw(2, 8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.max()) < 1000


def test_a_window_closes_on_whole_rounds():
    import time

    import smoke_cells as sc
    from harness import drivers
    from harness.model import port_config, shape
    from harness.traffic import round_length
    s = shape(sc.DS_SMOKE)
    ctx = drivers.Ctx(device=torch.device("cpu"), seed=2 ** 31 + 3,
                      seconds=0.01, trace=False, shape=s,
                      port_cfg=port_config(sc.DS_SMOKE), traffic=sc.PREFILL,
                      t_start=time.perf_counter())
    win = drivers.run_generate(ctx)
    per = round_length(sc.PREFILL["prompt"])
    ls = prompt_lengths(sc.PREFILL["prompt"])
    strata = [ls[2 * i:2 * i + 2] for i in range(per)]
    got = win.work["lengths"]
    assert per == 4 and len(got) == per       # one round, though 0.01 s
    assert all(st[0] <= x <= st[-1] for x, st in zip(sorted(got), strata))
    # the check's sample: whole batches, the longest among them
    sample = win.outputs["batches"]
    assert len(sample) == sc.PREFILL["check_batches"]
    assert max(p.shape[1] for p, _ in sample) == max(got)
