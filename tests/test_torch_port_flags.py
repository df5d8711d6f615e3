"""The registry of the port's knobs (``utils/flags.py``) against the code
that reads them.

Every ``cli.train`` flag that selects a path is registered (the flags
listed in ``NOT_A_PATH`` choose data, files, sizes or the device, not a
path), and each registered knob's default equals argparse's default of
its flag and the default of the keyword it names (by ``inspect``, no
call).  ``lookup`` finds every knob by name; the README's port section
carries ``markdown_table()`` verbatim; no evidence names a TPU or copies
a figure of ``PERF.md``.
"""

import importlib
import inspect
import os
import re

import pytest

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import train as cli
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils import flags

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "cooperative_training_and_latent_space_data_augmentation_tpu_torch"
NOT_A_PATH = {"help", "json_config_path", "cval", "data_setting", "save_dir", "log", "seed",
              "resume_path", "resume_orbax", "no_orbax", "root_dir", "synthetic",
              "synthetic_train_length", "synthetic_val_length", "batch_size", "lr",
              "max_epochs", "device"}


def _parser_defaults():
    """{dest: default} of cli.train's parser, read through parse_args."""
    return vars(cli.parse_args([]))


def test_every_path_selecting_flag_is_registered():
    dests = set(_parser_defaults())
    registered = {f.cli for f in flags.REGISTRY if f.cli}
    assert dests - NOT_A_PATH - registered == set()
    assert registered <= dests


@pytest.mark.parametrize("flag", flags.REGISTRY, ids=lambda f: f.name)
def test_defaults_equal_argparse_and_the_keyword(flag):
    if flag.cli is not None:
        assert _parser_defaults()[flag.cli] == flag.default
    if flag.keyword is not None:
        module, _, path = flag.keyword.partition(":")
        owner, param = path.rsplit(".", 1)
        obj = importlib.import_module(f"{PORT}.{module}")
        for part in owner.split("."):
            obj = getattr(obj, part)
        assert inspect.signature(obj).parameters[param].default == flag.default
    assert flag.cli is not None or flag.keyword is not None
    assert flag.kind in ("bool", "str", "int")


def test_where_names_a_real_symbol():
    for flag in flags.REGISTRY:
        path, _, symbol = flag.where.split(" ")[0].partition(":")
        module = importlib.import_module(PORT + "." + path[:-3].replace("/", "."))
        obj = module
        for part in symbol.split("."):
            obj = getattr(obj, part)


def test_evidence_is_the_cards_own():
    for flag in flags.REGISTRY:
        measured = "not measured on the card" not in flag.evidence
        if measured:
            assert flags.CARD in flag.evidence and "PERF.md section 5" in flag.evidence, \
                flag.name
            # the figures stay in PERF.md: no number but the card's limit
            assert not re.search(r"\d", flag.evidence.replace(flags.CARD, "").replace(
                "section 5", "")), flag.name
        assert "v5e" not in flag.evidence and "MXU" not in flag.evidence, flag.name


def test_evidence_names_an_entry_of_perf_md():
    """Each measured knob's evidence names a bold entry of PERF.md's
    section 5 (its words before the card)."""
    with open(os.path.join(REPO, "PERF.md")) as f:
        text = f.read()
    section = text[text.index("## 5."):text.index("## 6.")].lower()
    for flag in flags.REGISTRY:
        if "not measured on the card" in flag.evidence:
            continue
        entry = flag.evidence.split("PERF.md section 5, ")[1].split(" (")[0]
        for part in entry.split(" and "):
            assert part.removeprefix("the ").lower() in section, (flag.name, part)


def test_lookup_finds_every_knob():
    names = [f.name for f in flags.REGISTRY]
    assert len(set(names)) == len(names)
    for name in names:
        assert flags.lookup(name).name == name
    with pytest.raises(KeyError):
        flags.lookup("PALLAS_CONV")
    with pytest.raises(KeyError):
        flags.lookup("fast_conv")  # the staircase conv is no knob of the port


def test_readme_holds_the_table():
    with open(os.path.join(REPO, "README.md")) as f:
        assert flags.markdown_table() in f.read()
