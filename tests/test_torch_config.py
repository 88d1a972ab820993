"""Port config stack (hetu_galvatron_tpu_torch.core) against the JAX one.

The port reads YAML without PyYAML and validates into dataclasses without
pydantic; both must give what ``yaml.safe_load`` plus the JAX
``load_config`` give. Exact equality throughout (no arithmetic involved).
"""

import dataclasses
import glob
import math
import os

import pytest
import yaml

from hetu_galvatron_tpu.core import args_schema as JS
from hetu_galvatron_tpu.core import arguments as JA
from hetu_galvatron_tpu_torch.core import args_schema as TS
from hetu_galvatron_tpu_torch.core import arguments as TA

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..",
                          "hetu_galvatron_tpu", "models", "configs")
CONFIGS = sorted(glob.glob(os.path.join(CONFIG_DIR, "*.yaml")))

OVERRIDES = [
    "train.lr=1e-4", "train.min_lr=3E-6", "train.weight_decay=0.1",
    "++train.train_iters=7", "parallel.mixed_precision=fp32",
    "model.use_flash_attn=false", "model.tie_word_embeddings=yes",
    "train.rampup_batch_size=[4,4,100]", "data.data_path=[a, 'b c']",
    "ckpt.save=null", "logging.log_level=debug", "model.rope_theta=5e5",
    "model.rope_scaling={factor: 8.0, rope_type: llama3}",
    "extra.tag=a,b", "extra.hex=0x1f", "extra.neg=-12", "extra.flt=.5",
    "extra.sci=-2.5e+3", "extra.empty=", "extra.quoted='x: y'",
]


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return a == b and type(a) is type(b)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_torch_yaml_subset_reader_matches_pyyaml(path):
    with open(path) as f:
        text = f.read()
    assert TA.safe_load(text) == yaml.safe_load(text)
    # include: resolution and deep merge
    assert TA._load_yaml(path) == JA._load_yaml(path)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_torch_load_config_matches_jax_fields(path):
    ours = TA.load_config(path, OVERRIDES[:6])
    theirs = JA.load_config(path, OVERRIDES[:6])
    for section in TS.SECTIONS:
        mine = getattr(ours, section)
        ref = getattr(theirs, section)
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(ref, f.name), \
                f"{section}.{f.name}"
    m = ours.model
    assert (m.padded_vocab_size, m.head_dim, m.kv_heads, m.ffn_dim) == (
        theirs.model.padded_vocab_size, theirs.model.head_dim,
        theirs.model.kv_heads, theirs.model.ffn_dim)


def test_torch_parse_overrides_matches_jax():
    ours = TA.parse_overrides(OVERRIDES)
    theirs = JA.parse_overrides(OVERRIDES)
    assert ours == theirs

    def walk(a, b, where=""):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], f"{where}.{k}")
        elif isinstance(a, list):
            for x, y in zip(a, b):
                walk(x, y, where)
        else:
            assert _same(a, b), (where, a, b)
    walk(ours, theirs)
    # bare NaN reads as float NaN in both, like the JAX rerun.inject_kind
    assert math.isnan(TA.parse_overrides(["x=nan"])["x"])
    assert TA.parse_overrides(["x=.nan"]).keys() == {"x"}


def test_torch_schema_fields_match_jax_schema():
    """Every port field exists in the JAX schema with the same default, and
    every JAX field is either ported or listed as accepted-but-unread."""
    jax_sections = {name: JS.CoreArgs.model_fields[name].annotation
                    for name in JS.CoreArgs.model_fields
                    if name not in ("mode", "extra")}
    for name, jcls in jax_sections.items():
        jfields = set(jcls.model_fields)
        if name in TS.SECTIONS:
            tcls = TS.SECTIONS[name]
            tfields = {f.name for f in dataclasses.fields(tcls)}
            assert tfields <= jfields, (name, tfields - jfields)
            defaults = tcls()
            jdefaults = jcls()
            for f in tfields:
                assert getattr(defaults, f) == getattr(jdefaults, f), \
                    f"{name}.{f}"
            unread = TS.JAX_ONLY_KEYS.get(name, frozenset())
            assert tfields | unread == jfields, (name, jfields - tfields
                                                 - unread)
        else:
            assert TS.JAX_ONLY_KEYS[name] == jfields, name


def test_torch_config_rejects_unknown_and_bad_values():
    # a key the JAX schema knows but the port does not read loads
    args = TA.load_config(None, ["model.untie_streams=true",
                                 "search.max_bsz=32", "serving.spec_k=2",
                                 "model.moe_topk=4",
                                 "model.num_encoder_layers=4"])
    assert args.device == "cuda"
    # the MoE keys are read since the MoE layers were ported, and the t5
    # encoder depth since the encoder-decoder was
    assert args.model.moe_topk == 4
    assert args.model.num_encoder_layers == 4
    with pytest.raises(ValueError, match="moe_dispatcher"):
        TA.load_config(None, ["model.moe_dispatcher=alltoall"])
    with pytest.raises(ValueError, match="unknown config key"):
        TA.load_config(None, ["model.not_a_field=1"])
    with pytest.raises(ValueError, match="unknown config key"):
        TA.load_config(None, ["search.not_a_field=1"])
    with pytest.raises(ValueError, match="unknown config section"):
        TA.load_config(None, ["nosuch.x=1"])
    with pytest.raises(ValueError, match="mixed_precision"):
        TA.load_config(None, ["parallel.mixed_precision=int8"])
    with pytest.raises(ValueError, match="device"):
        TA.load_config(None, ["device=tpu"])
    with pytest.raises(ValueError, match="key=value"):
        TA.parse_overrides(["train.lr"])
    assert TA.load_config(None, ["device=cpu"]).device == "cpu"


def test_torch_args_from_cli_picks_the_yaml():
    path = os.path.join(CONFIG_DIR, "gpt2-small.yaml")
    args = TA.args_from_cli(["train.lr=2e-4", path, "device=cpu"],
                            mode="train_dist")
    assert args.model.model_name == "gpt2-small"
    assert args.model.padded_vocab_size == 50304
    assert args.train.lr == 2e-4 and isinstance(args.train.lr, float)
    assert args.device == "cpu"
