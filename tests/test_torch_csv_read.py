"""``core/csvio.read_csv`` (the port's pandas-free CSV reader) against
``pd.read_csv(path, keep_default_na=False, na_values=["_"])``, the call
interseg makes on ``stat_fish_lsq.csv`` (``ecseg_tpu/pipelines/interseg.py:184-188``):
each column's dtype and values, on int, float, str, ``_`` (NaN), all-digit,
empty, bool, quoted and short-row columns, blank lines, a header-only file,
and a stat_fish CSV written by pandas; then interseg's quality gate
(``interseg.quality_passes``) against the JAX package's expression on the
same files.  Floats: the port parses with ``float()`` (correctly rounded);
pandas' converter is not (its error reached 758 ulps on [0, 255), ROADMAP
A1), so float values are compared within a relative 1e-12 and the gate's
decision exactly (ROADMAP §C)."""

import math

import numpy as np
import pandas as pd
import pytest
from scipy.stats import kurtosis

from ecseg_torch.core.csvio import read_csv
from ecseg_torch.pipelines.interseg import quality_passes

FILES = {
    "mixed": "a,b,c,d,e\n001,1.5,x,_,\n002,2,y,3,\n",
    "int_with_na": "a,b\n1,_\n2,3\n",
    "header_only": "image_name,Avg fish intensity (green)\n",
    "bool_inf": "a,b\nTrue,inf\nFalse,-Infinity\n",
    "nan_text": "a,b\nnan,NaN\n1,2\n",
    "exponents_signs": "a,b\n1e3,+5\n.5,-0\n",
    "spaces": "a,b\n 5,5 \n6,6\n",
    "underscore_digits": "a,b\n5.,1_000\n6,6\n",
    "quoted": 'a,b\n"1",2\n"x,y",3\n"7","8.5"\n',
    "all_na": "a\n_\n_\n",
    "blank_lines": "a,b\n1,2\n\n3,4\n",
    "short_row": "a,b,c\n1,2\n3,4,5\n",
    "bool_with_na": "a,b\nTrue,_\nFalse,x\n",
    "empty_column": "a,b\n,1\n,2\n",
}


def _pandas(path):
    return pd.read_csv(path, keep_default_na=False, na_values=["_"])


def _same_value(x, y, dtype):
    if isinstance(x, float) and isinstance(y, float):
        if math.isnan(x) or math.isnan(y):
            return math.isnan(x) and math.isnan(y)
        return x == y or (dtype == "float64" and abs(x - y) <= 1e-12 * abs(x))
    return type(x) is type(y) and x == y


def _assert_matches_pandas(path):
    df = _pandas(path)
    got = read_csv(path)
    assert list(got) == list(df.columns)
    for name in df.columns:
        kind = str(df[name].dtype)
        want_dtype = kind if kind in ("int64", "float64", "bool") else "str"
        assert got[name].dtype == want_dtype, (name, kind, got[name])
        want = df[name].tolist()
        assert len(got[name]) == len(want)
        assert all(_same_value(x, y, want_dtype) for x, y in zip(got[name].values, want)), (name, got[name].values, want)


@pytest.mark.parametrize("case", sorted(FILES))
def test_read_csv_matches_pandas(tmp_path, case):
    path = tmp_path / "t.csv"
    path.write_text(FILES[case])
    _assert_matches_pandas(str(path))


def _stat_fish_frame(rng, names, n_per_image):
    rows = {"image_name": [], "nucleus_center": [], "Avg fish intensity (green)": [], "Avg fish intensity (red)": []}
    for name in names:
        for k in range(n_per_image):
            rows["image_name"].append(name)
            rows["nucleus_center"].append(f"{k * 7}_{k * 11}")
            rows["Avg fish intensity (green)"].append(float(rng.random() * 255))
            # one bright nucleus an image: a heavy tail, kurtosis > 3
            rows["Avg fish intensity (red)"].append(float(250 - rng.random() if k == 0 else rng.random() * 3))
    return pd.DataFrame(rows)


def _jax_gate(path, name, cent):
    """The JAX package's expression (interseg.py:184-188, 208-217)."""
    stat = _pandas(path)
    img_rows = stat[stat["image_name"] == name]
    quality = kurtosis(img_rows[f"Avg fish intensity ({cent})"]) if len(stat) else float("inf")
    return bool(quality <= 3)


@pytest.mark.parametrize(
    "names, n_per_image, na",
    [
        (["cells", "b_cells"], 12, False),
        (["001", "002"], 5, False),  # all digits: int64 names, no row matches
        (["cells", "lone"], 1, False),  # one row an image: kurtosis NaN
        (["cells"], 7, True),  # an "_" in the column: NaN
        ([], 0, False),  # header only: quality inf
    ],
    ids=["str_names", "digit_names", "one_row", "na_cell", "header_only"],
)
def test_quality_gate_matches_the_jax_expression(tmp_path, names, n_per_image, na):
    rng = np.random.default_rng(len(names) * 10 + n_per_image)
    df = _stat_fish_frame(rng, names, n_per_image)
    if na:
        df["Avg fish intensity (green)"] = df["Avg fish intensity (green)"].astype(object)
        df.loc[2, "Avg fish intensity (green)"] = "_"
    path = str(tmp_path / "stat_fish_lsq.csv")
    df.to_csv(path, index=False)
    _assert_matches_pandas(path)
    table = read_csv(path)
    for name in names + ["absent"]:
        for cent in ("green", "red"):
            assert quality_passes(table, name, cent) == _jax_gate(path, name, cent), (name, cent)
    if names == ["cells", "b_cells"]:  # the fixture exercises both outcomes
        assert {quality_passes(table, n, c) for n in names for c in ("green", "red")} == {True, False}
