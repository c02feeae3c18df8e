"""The manifest's rules, and every file it names is there."""
import copy
import json

import pytest

from harness import manifest

M = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())


def test_the_manifest_is_valid():
    manifest.validate(M)


def test_every_named_file_is_there():
    for c in M["configs"]:
        assert (manifest.ROOT / c["file"]).is_file()
    for w in M["workloads"]:
        assert manifest.traffic_of(w)["kind"] in ("train", "generate")
        assert manifest.checks_of(w)
    for p in M["per_layer"]:
        assert callable(manifest.metric_reader(p["name"]))


def test_each_per_layer_metric_moves_what_its_cells_report():
    for p in M["per_layer"]:
        for w in p["workloads"]:
            assert p["moves"] in manifest.end_to_end_of(M, w)


def _broken(edit):
    m = copy.deepcopy(M)
    edit(m)
    return m


BROKEN = {
    "space_in_name": lambda m: m["workloads"][0].update(name="ds16b train"),
    "slash_in_name": lambda m: m["per_layer"][0].update(name="a/b"),
    "unit_with_space": lambda m: m["end_to_end"][0].update(
        unit="tokens per s"),
    "greek_unit": lambda m: m["end_to_end"][0].update(unit="µs"),
    "moves_unreported": lambda m: m["per_layer"][0].update(
        moves="decode_tok_s"),
    "moves_setup": lambda m: m["per_layer"][0].update(moves="setup_s"),
    "no_setup_s": lambda m: m["end_to_end"].pop(),
    "loose_bound": lambda m: m["end_to_end"][0].update(bound=0.3),
    "e2e_program_source": lambda m: m["end_to_end"][0].update(
        source="program_span"),
    "extra_key": lambda m: m["per_layer"][0].update(why="x"),
    "cell_twice": lambda m: m["workloads"].append(
        dict(m["workloads"][0], name="other")),
    "long_why": lambda m: m["workloads"][0].update(why="x" * 201),
}


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_a_broken_manifest_is_refused(case):
    with pytest.raises(manifest.ManifestError):
        manifest.validate(_broken(BROKEN[case]))
