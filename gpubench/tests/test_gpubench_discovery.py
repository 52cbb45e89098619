"""A configuration, a mix, a metric or a kernel count dropped in as a
new file is found by its name, with no file that is there edited."""

import json
import shutil

from gpubench import manifest as man
from gpubench import metrics as readers
from gpubench import mix as mixmod
from gpubench import roofline


def test_new_files_are_found(tmp_path, monkeypatch):
    root = tmp_path / "gpubench"
    shutil.copytree(man.HERE, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    cfg = json.loads((root / "configs" / "able-1b.json").read_text())
    cfg["name"] = "able-2b"
    cfg["shards"] = 1908
    (root / "configs" / "able-2b.json").write_text(json.dumps(cfg))
    (root / "traffic" / "able-counts.json").write_text(json.dumps({
        "clients": 2, "forms": [{"name": "c", "weight": 1, "front": "pql",
                                 "op": "count", "where": []}]}))
    (root / "metrics" / "serving.nothing.py").write_text(
        "def read(b):\n    return None\n")
    (root / "roofline" / "new_kernel.py").write_text(
        "KERNEL = 'new_kernel'\nSYMBOLS = ('new_kernel_kernel',)\n"
        "WRAPPERS = {'new_kernel': lambda x: {'bytes': 4}}\n")
    monkeypatch.setattr(man, "HERE", root)
    monkeypatch.setattr(mixmod, "HERE", root)
    monkeypatch.setattr(readers, "HERE", root / "metrics")
    monkeypatch.setattr(roofline, "HERE", root / "roofline")

    assert man.config("able-2b")["shards"] == 1908
    m = mixmod.Mix(mixmod.load("able-counts"), cfg)
    assert next(m.stream(1)) == {"name": "c", "front": "pql",
                                    "op": "count", "where": []}
    assert readers.load("serving.nothing").read(None) is None
    assert "new_kernel" in roofline.load_all()
