"""The port's YAML reader (`leco_tpu_torch/utils/yaml_subset.py`) against
PyYAML's `safe_load`: every YAML file under examples/, scalar resolution
cases, and the constructs outside the subset, which raise with their line."""

from pathlib import Path

import pytest
import yaml

from leco_tpu_torch.utils import yaml_subset

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.mark.parametrize("path", sorted(EXAMPLES.glob("*.yaml")), ids=lambda p: p.name)
def test_example_files_match_safe_load(path):
    assert yaml_subset.load(path) == yaml.safe_load(path.read_text())


@pytest.mark.parametrize(
    "text",
    [
        "lr: 1e-4",  # YAML 1.1: no dot, so a string (the config layer coerces it)
        "lr: 5e3",
        "lr: 1.0e-4",
        "lr: 1.e+3",
        "x: .5",
        "x: -.inf",
        "x: 1_000",
        "x: 0x1F",
        "x: 017",
        "x: 0b101",
        "x: +12",
        "x: yes",
        "x: Off",
        "x: TRUE",
        "x: ~",
        "x:",
        "x: ''",
        'x: ""',
        "x: 'it''s'",
        'x: "tab\\tand \\u00e9"',
        "x: b # a comment",
        "x: b#not-a-comment",
        "x: /models/sd:2.1",
        "'quoted key': 1",
        "1: 2",
        "a:\n- 1\n- 2\nb: 3",
        "a:\n  - b: 1\n    c: 'x'\n  - d\n",
        "- - 1\n  - 2\n- 3",
        "- [1, 'a', {b: c}]\n- {x: , y: 2}",
        "# only a comment\n\n",
    ],
)
def test_scalars_and_nesting_match_safe_load(text):
    got, want = yaml_subset.loads(text), yaml.safe_load(text)
    assert repr(got) == repr(want)


@pytest.mark.parametrize(
    "text,line",
    [
        ("a: 1\nb: &anchor 2", 2),
        ("a: *alias", 1),
        ("a: !!str 1", 1),
        ("a: |\n  block", 1),
        ("---\na: 1", 1),
        ("a: 2002-12-14", 1),
        ("a: 1:30", 1),
        ("a:\n  first\n  second", 3),
        ("a: 'unterminated", 1),
        ("a: b: c", 1),
    ],
)
def test_constructs_outside_the_subset_raise_with_their_line(text, line):
    with pytest.raises(yaml_subset.YAMLSubsetError, match=f"^line {line}:"):
        yaml_subset.loads(text)
