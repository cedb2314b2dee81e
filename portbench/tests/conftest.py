"""The small cells of the harness's CPU tests (``_cells.py``), written once
a session under a temporary folder."""

import pytest

from portbench.tests._cells import write_cells


@pytest.fixture(scope="session")
def cells(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cells"))
    return root, write_cells(root)
