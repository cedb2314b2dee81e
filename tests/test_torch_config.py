"""The port's config reader (``ecseg_torch.core.config``), which reads the
YAML subset of ``config.yaml`` and ``stat_fish_params.yaml`` without PyYAML:
equal to ``yaml.safe_load`` on both files and on generated scalars and flow
lists of the subset, never a different value on text outside it (it raises
``ConfigError`` instead), and working with ``yaml`` unimportable."""

import pathlib
import sys

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from ecseg_torch.core.config import Config, ConfigError, load_config, parse_yaml_subset

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["config.yaml", "ecseg_tpu/stat_fish_params.yaml"])
def test_reader_equals_safe_load_on_the_repo_files(name):
    text = (REPO / name).read_text()
    got = parse_yaml_subset(text, name)
    assert got == yaml.safe_load(text)
    assert [type(v) for v in _leaves(got)] == [type(v) for v in _leaves(yaml.safe_load(text))]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


_BOOLS = ["yes", "Yes", "YES", "no", "No", "NO", "true", "True", "TRUE", "false", "False", "FALSE", "on", "On", "ON", "off", "Off", "OFF"]
# plain words that safe_load reads as strings: the alphabet also spells
# octal, hex, binary and underscored numbers and dates ("00", "0x1f",
# "1_0", "2020-01-01"), which the subset refuses (test_reader_never_guesses)
# and which safe_load may not even construct ("0b_" raises)
_STR_TAG = "tag:yaml.org,2002:str"
_WORD = st.text(st.sampled_from("abcxyzXY_/.-0123456789"), min_size=1, max_size=12).filter(
    lambda s: s[0] not in "-." and yaml.resolver.Resolver().resolve(yaml.ScalarNode, s, (True, False)) == _STR_TAG
)
_SCALARS = st.one_of(
    st.integers(-10**12, 10**12).map(str),
    st.integers(0, 10**6).map(lambda i: f"+{i}"),
    st.floats(allow_nan=False, allow_infinity=False).map(repr).filter(lambda s: "e" not in s),
    st.tuples(st.integers(0, 999), st.integers(0, 999)).map(lambda t: f"{t[0]}.{t[1]}"),
    st.integers(0, 999).map(lambda i: f".{i}"),
    st.integers(0, 999).map(lambda i: f"{i}."),
    st.tuples(st.integers(0, 99), st.integers(0, 99), st.sampled_from("eE"), st.sampled_from("+-")).map(lambda t: f"{t[0]}.{t[1]}{t[2]}{t[3]}{t[1]}"),
    st.sampled_from(_BOOLS + ["~", "null", "Null", "NULL"]),
    _WORD,
    st.tuples(_WORD, _WORD).map(" ".join),
)


@settings(max_examples=300, deadline=None, database=None)
@given(st.lists(_SCALARS, min_size=1, max_size=4), _SCALARS)
def test_reader_equals_safe_load_on_generated_subset(items, scalar):
    """Scalars and flow lists of the subset: never refused, equal to
    safe_load in value and type."""
    text = f"top:\n  key: {scalar}  # comment\n  list: [{', '.join(items)}]\nother: {items[0]}\n"
    got = parse_yaml_subset(text, "gen.yaml")
    want = yaml.safe_load(text)
    assert got == want
    assert [type(v) for v in _leaves(got)] == [type(v) for v in _leaves(want)]


@settings(max_examples=400, deadline=None, database=None)
@given(st.text(st.sampled_from("ab01 .:-#'\"[],~_+eE"), max_size=10))
def test_reader_never_guesses(value):
    """Any value text: the reader gives what safe_load gives, or raises
    ConfigError; never another value."""
    text = f"k: {value}\n"
    try:
        got = parse_yaml_subset(text, "any.yaml")
    except ConfigError:
        return
    want = yaml.safe_load(text)
    assert got == want and [type(v) for v in _leaves(got)] == [type(v) for v in _leaves(want)], (text, got, want)


@pytest.mark.parametrize(
    "text",
    [
        "a: &x 1\nb: *x\n",  # anchor, alias
        "a: !!str 1\n",  # tag
        "a:\n  - 1\n  - 2\n",  # block list
        "a: |\n  text\n",  # block scalar
        "a: >\n  text\n",
        "a: one\n  two\n",  # multi-line plain scalar
        'a: "esc\\n"\n',  # double-quoted with an escape
        "a: 'open\n",  # quoted scalar over lines
        "a: [1,\n  2]\n",  # flow list over lines
        "a: {b: 1}\n",  # flow mapping
        "a:\t1\n",  # tab
        "a: 1\na: 2\n",  # duplicate key
        "a:\n  b: 1\n  b: 2\n",
        "---\na: 1\n",  # document marker
        "%YAML 1.1\na: 1\n",  # directive
        "a: 0x1F\n",  # numbers safe_load reads in forms the subset leaves out
        "a: 017\n",
        "a: 1_000\n",
        "a: 3:30\n",
        "a: .inf\n",
        "a: 2001-12-14\n",
        "a: [1, [2]]\n",
        "a: b: c\n",
        "a:\n    b: 1\n  c: 2\n",  # indentation that continues no key
    ],
)
def test_unsupported_constructs_raise(text):
    with pytest.raises(ConfigError, match=r"bad\.yaml:\d+: .*outside the YAML subset"):
        parse_yaml_subset(text, "bad.yaml")


def test_load_config_needs_no_yaml(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml now raises
    with pytest.raises(ImportError):
        import yaml as _  # noqa: F401
    p = tmp_path / "config.yaml"
    p.write_text((REPO / "config.yaml").read_text())
    cfg = load_config(str(p))
    assert cfg.metaseg.inpath == "./example_ecSeg" and cfg.path == str(p)


def test_load_config_errors(tmp_path):
    with pytest.raises(ConfigError, match="config file not found"):
        load_config(str(tmp_path / "missing.yaml"))
    empty = tmp_path / "empty.yaml"
    empty.write_text("# nothing but a comment\n")
    with pytest.raises(ConfigError, match="did not parse to a mapping"):
        load_config(str(empty))
    nosec = tmp_path / "nosec.yaml"
    nosec.write_text("metaseg:\nstat_fish:\n  scale: 1\n")
    with pytest.raises(ConfigError, match="no 'metaseg' section"):
        load_config(str(nosec)).metaseg
    nokey = tmp_path / "nokey.yaml"
    nokey.write_text("metaseg:\n  other: 1\n")
    with pytest.raises(ConfigError, match="missing required key 'inpath'"):
        load_config(str(nokey)).metaseg
    assert Config(raw={"metaseg": {"inpath": "x"}}).metaseg.inpath == "x"


def test_task_sections_equal_the_jax_package_on_config_yaml():
    """The meta_overlay and fish_distance_calculation sections of the
    repository's config.yaml, read by the port, equal the JAX package's
    (PyYAML) reading, with the colour -> channel index map."""
    from ecseg_tpu.core import config as jax_config

    ours, theirs = load_config(str(REPO / "config.yaml")), jax_config.load_config(str(REPO / "config.yaml"))
    assert ours.meta_overlay.__dict__ == theirs.meta_overlay.__dict__
    ours_fd, theirs_fd = ours.fish_distance_calculation, theirs.fish_distance_calculation
    for key in ("inpath", "centromere_probe_color", "fish_probe_color", "max_centromeric_spots",
                "centromere_probe_index", "fish_probe_index"):
        assert getattr(ours_fd, key) == getattr(theirs_fd, key), key
    assert (ours_fd.centromere_probe_index, ours_fd.fish_probe_index) == (1, 0)  # green, red


@pytest.mark.parametrize("sensitivity", [-1, 0, 255, 256, 300])
def test_color_sensitivity_range_as_the_jax_package(sensitivity):
    from ecseg_tpu.core import config as jax_config

    raw = {"meta_overlay": {"inpath": ".", "color_sensitivity": sensitivity}}
    if 0 <= sensitivity <= 255:
        assert Config(raw=raw).meta_overlay.color_sensitivity == jax_config.Config(raw=raw).meta_overlay.color_sensitivity
    else:
        with pytest.raises(ConfigError, match="between 0 and 255"):
            Config(raw=raw).meta_overlay
        with pytest.raises(jax_config.ConfigError, match="between 0 and 255"):
            jax_config.Config(raw=raw).meta_overlay


def test_missing_task_sections_and_keys_raise():
    with pytest.raises(ConfigError, match="no 'meta_overlay' section"):
        Config(raw={"metaseg": {"inpath": "."}}).meta_overlay
    with pytest.raises(ConfigError, match="missing required key 'max_centromeric_spots'"):
        Config(raw={"fish_distance_calculation": {
            "inpath": ".", "centromere_probe_color": "green", "fish_probe_color": "red",
        }}).fish_distance_calculation
