"""The PyTorch port stands alone: no JAX, no JAX package, CUDA by default."""
import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = {"jax", "jaxlib", "repro"} & set(_imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_engine_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    from repro_torch.core.engine import EngineConfig, SearchAssistanceEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = EngineConfig(query_capacity=1 << 8, cooc_capacity=1 << 8,
                       session_capacity=1 << 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        SearchAssistanceEngine(cfg)
    assert SearchAssistanceEngine(cfg, device="cpu").device.type == "cpu"


def _cfg():
    from repro_torch.core.engine import EngineConfig
    return EngineConfig(query_capacity=1 << 8, cooc_capacity=1 << 8,
                        session_capacity=1 << 8)


def _init_state(**kw):
    from repro_torch.core.engine import init_state
    return init_state(_cfg(), **kw).tick


def _make_cooc_store(**kw):
    from repro_torch.core.engine import make_cooc_store
    return make_cooc_store(_cfg(), **kw).key_hi


def _make_table(**kw):
    from repro_torch.core.stores import make_table
    return make_table(1 << 8, {"weight": torch.float32}, **kw).key_hi


def _make_session_table(**kw):
    from repro_torch.core.stores import make_session_table
    return make_session_table(1 << 8, 4, **kw).key_hi


def _make_region_cooc_store(**kw):
    import dataclasses
    from repro_torch.core.engine import make_cooc_store
    cfg = dataclasses.replace(_cfg(), cooc_layout="region")
    return make_cooc_store(cfg, **kw).chain_region


def _make_region_table(**kw):
    from repro_torch.core.stores import make_region_table
    return make_region_table(1 << 8, 16, 1 << 8, 4,
                             {"weight": torch.float32}, **kw).region_owner


def _make_sketch(**kw):
    from repro_torch.core.sketch import make_sketch
    return make_sketch(2, 1 << 8, **kw).table


def _smoke_lm(arch="h2o-danube-1.8b"):
    from repro_torch.configs import get_arch
    return get_arch(arch).smoke_config


def _init_params(**kw):
    from repro_torch.models.transformer import init_params
    gen = torch.Generator()
    return init_params(_smoke_lm(), generator=gen, **kw).embed


def _init_moe_lm(**kw):
    from repro_torch.models.transformer import init_params
    return init_params(_smoke_lm("qwen2-moe-a2.7b"), generator=torch.Generator(),
                       **kw).blocks[0].moe.shared.gate


def _init_moe(**kw):
    from repro_torch.models.moe import init_moe
    cfg = _smoke_lm("mixtral-8x22b").moe
    return init_moe(16, cfg, torch.float32, generator=torch.Generator(),
                    **kw).w_down


def _moe_from_jax(**kw):
    from repro_torch.models.convert import moe_from_jax
    from repro_torch.models.moe import init_moe
    cfg = _smoke_lm("qwen2-moe-a2.7b").moe
    tree = {n: t.numpy() for n, t in init_moe(
        16, cfg, torch.float32, generator=torch.Generator(),
        device="cpu").state_dict().items()}
    tree["shared"] = {n.split(".")[1]: tree.pop(n) for n in list(tree)
                      if n.startswith("shared.")}
    return moe_from_jax(tree, 16, cfg, torch.float32, **kw).router


def _make_moe_inputs(**kw):
    import numpy as np
    from repro_torch.models.api import ShapeCell, make_inputs
    cell = ShapeCell("d", "decode", {"batch": 2, "seq": 16})
    return make_inputs(np.random.default_rng(0), _smoke_lm("mixtral-8x22b"),
                       cell, **kw)["caches"]["v"]


def _init_caches(**kw):
    from repro_torch.models.transformer import init_caches
    return init_caches(_smoke_lm(), 2, 32, **kw)["k"]


def _make_inputs(**kw):
    import numpy as np
    from repro_torch.models.api import ShapeCell, make_inputs
    cell = ShapeCell("p", "prefill", {"batch": 2, "seq": 16})
    return make_inputs(np.random.default_rng(0), _smoke_lm(), cell,
                       **kw)["tokens"]


def _params_from_jax(**kw):
    from repro_torch.models.convert import params_from_jax, params_to_numpy
    from repro_torch.models.transformer import init_params
    tree = params_to_numpy(init_params(_smoke_lm(), generator=torch.Generator(),
                                       device="cpu"))
    return params_from_jax(tree, _smoke_lm(), **kw).lm_head


def _init_recsys(**kw):
    from repro_torch.configs import get_arch
    from repro_torch.models.api import init_params
    return init_params(get_arch("bst").smoke_config,
                       generator=torch.Generator(), **kw).item_emb


def _init_gat(**kw):
    from repro_torch.configs import get_arch
    from repro_torch.models.api import init_params
    return init_params(get_arch("gat-cora").smoke_config,
                       generator=torch.Generator(), **kw).layers[0].w


def _make_recsys_inputs(**kw):
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.models.api import ShapeCell, make_inputs
    cell = ShapeCell("s", "serve", {"batch": 4})
    return make_inputs(np.random.default_rng(0),
                       get_arch("two-tower-retrieval").smoke_config, cell,
                       **kw)["batch"]["hist"]


def _model_from_jax(**kw):
    from repro_torch.configs import get_arch
    from repro_torch.models.api import init_params
    from repro_torch.models.convert import model_from_jax, model_to_numpy
    cfg = get_arch("xdeepfm").smoke_config
    tree = model_to_numpy(init_params(cfg, generator=torch.Generator(),
                                      device="cpu"))
    return model_from_jax(tree, cfg, **kw).cin[0]


def _batch_pipeline(**kw):
    from repro_torch.data.batch_pipeline import (BatchPipeline,
                                                 HadoopLatencyModel)
    return BatchPipeline(_cfg(), HadoopLatencyModel(), 30.0, **kw)


@pytest.mark.parametrize("make", [_init_state, _make_cooc_store, _make_table,
                                  _make_session_table,
                                  _make_region_cooc_store,
                                  _make_region_table, _make_sketch,
                                  _init_params, _init_caches, _make_inputs,
                                  _params_from_jax, _init_moe_lm, _init_moe,
                                  _moe_from_jax, _make_moe_inputs,
                                  _init_recsys, _init_gat,
                                  _make_recsys_inputs, _model_from_jax,
                                  _batch_pipeline],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_state_constructors_default_to_cuda_and_refuse_without_it(
        monkeypatch, make):
    """The functional path (``init_state`` + ``ingest_many``) never lands on
    the CPU, and so on the plain versions, unless the caller asks."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make()
    assert make(device="cpu").device.type == "cpu"


def test_spelling_cycle_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    import numpy as np
    from repro_torch.core.spelling import spelling_cycle
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    texts = ["hadoop", "hadop"]
    args = (np.array([1, 2], np.uint64), texts, np.array([9.0, 1.0]))
    with pytest.raises(RuntimeError, match="CUDA"):
        spelling_cycle(*args)
    assert spelling_cycle(*args, device="cpu") == {2: (1, 1.0)}


def _assistance_service(tmp_path, **kw):
    from repro_torch.core.background import AssistanceService
    return AssistanceService(_cfg(), **kw).bg.device


def _recover_service(tmp_path, **kw):
    from repro_torch.distributed.fault_tolerance import CheckpointManager
    from repro_torch.streaming import recover_service
    svc, _ = recover_service(_cfg(), CheckpointManager(str(tmp_path / "rt")),
                             CheckpointManager(str(tmp_path / "bg")),
                             str(tmp_path / "log"), **kw)
    return svc.rt.device


def _serve_assist_run(tmp_path, **kw):
    from repro_torch.data.stream import StreamConfig
    from repro_torch.launch import serve_assist
    res = serve_assist.run(
        _cfg(), StreamConfig(vocab_size=64, n_users=16, queries_per_tick=8,
                             tweets_per_tick=2),
        serve_assist.AssistOptions(ticks=1, out=str(tmp_path), replicas=2,
                                   fail_replica_at=-1, crash_at=-1,
                                   recover=False, full_every=4,
                                   slow_io_ms=0.0),
        log=lambda s: None, **kw)
    return res["bg"].device


def _overload_service(tmp_path, **kw):
    from repro_torch.core.background import AssistanceService
    from repro_torch.streaming import SLOConfig
    return AssistanceService(_cfg(), slo=SLOConfig(), **kw).rt.device


def _log_compactor(tmp_path, **kw):
    from repro_torch.streaming import LogCompactor
    return LogCompactor(str(tmp_path / "log"), {"rt": _cfg()}, **kw).device


def _serve_assist_firehose_run(tmp_path, **kw):
    from repro_torch.data.stream import StreamConfig
    from repro_torch.launch import serve_assist
    res = serve_assist.run(
        _cfg(), StreamConfig(),
        serve_assist.AssistOptions(ticks=1, out=str(tmp_path), replicas=2,
                                   fail_replica_at=-1, crash_at=-1,
                                   recover=False, full_every=4,
                                   slow_io_ms=0.0, slo_ms=50.0,
                                   workload="firehose", compact_every=1),
        log=lambda s: None, **kw)
    return res["compactor"].device


def _serve_assist_main(tmp_path, device=None):
    from repro_torch.launch import serve_assist
    argv = ["--ticks", "1", "--replicas", "1", "--out", str(tmp_path)]
    assert serve_assist.main(argv + (["--device", device] if device else
                                     [])) == 0
    return torch.device(device)


def _serving_fleet(tmp_path, **kw):
    from repro_torch.distributed.fleet import FleetConfig, ServingFleet
    fleet = ServingFleet(str(tmp_path), _cfg(),
                         FleetConfig(n_replicas=2, compact_every=1), **kw)
    (device,) = {fleet.compactor.device} | {
        e.device for r in fleet._replicas for e in (r.service.rt,
                                                     r.service.bg)}
    return device


def _serve_assist_fleet_main(tmp_path, device=None):
    from repro_torch.launch import serve_assist
    argv = ["--fleet", "2", "--ticks", "1", "--out", str(tmp_path)]
    assert serve_assist.main(argv + (["--device", device] if device else
                                     [])) == 0
    return torch.device(device)


@pytest.mark.parametrize("entry", [_assistance_service, _recover_service,
                                   _serve_assist_run, _serve_assist_main,
                                   _overload_service, _log_compactor,
                                   _serve_assist_firehose_run,
                                   _serving_fleet, _serve_assist_fleet_main],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_serving_entry_points_default_to_cuda_and_refuse_without_it(
        monkeypatch, tmp_path, entry):
    """The serving stack's entry points run on CUDA unless the caller asks
    for the CPU, and raise where CUDA is absent."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry(tmp_path / "cuda")
    assert entry(tmp_path / "cpu", device="cpu").type == "cpu"


def _sharded_config():
    from repro_torch.core.sharded_engine import ShardedConfig
    return ShardedConfig(base=_cfg(), route_capacity=64)


def _sharded_state():
    from repro_torch.core.sharded_engine import init_sharded_state
    return init_sharded_state(_sharded_config(), 2, device="cpu")


def _hose(n_ticks=None):
    import numpy as np
    rng = np.random.default_rng(0)
    shape = (8,) if n_ticks is None else (n_ticks, 8)
    u32 = lambda: rng.integers(1, 2**32, shape, dtype=np.uint32)
    return (u32(), u32(), u32(), u32(), np.zeros(shape, np.int32),
            np.ones(shape, bool))


def _init_sharded_state(tmp_path, **kw):
    from repro_torch.core.sharded_engine import init_sharded_state
    return init_sharded_state(_sharded_config(), 2, **kw).tick.device


def _sharded_hose_step(make):
    def entry(tmp_path, **kw):
        from repro_torch.core import sharded_engine as se
        step = getattr(se, make)(_sharded_config(), 2, **kw)
        many = make == "make_sharded_ingest_many"
        return step(_sharded_state(), *_hose(2 if many else None)).tick.device
    entry.__name__ = make
    return entry


def _make_sharded_decay(tmp_path, **kw):
    from repro_torch.core.sharded_engine import make_sharded_decay
    return make_sharded_decay(_sharded_config(), 2, **kw)(
        _sharded_state(), 4).tick.device


def _make_sharded_rank(tmp_path, **kw):
    from repro_torch.core.sharded_engine import make_sharded_rank
    return make_sharded_rank(_sharded_config(), 2, **kw)(
        _sharded_state()).score.device


def _restore_sharded_snapshot(tmp_path, **kw):
    from repro_torch.core.sharded_engine import (restore_sharded_snapshot,
                                                 save_sharded_snapshot)
    from repro_torch.distributed.fault_tolerance import CheckpointManager
    ckpt = CheckpointManager(str(tmp_path))
    save_sharded_snapshot(_sharded_state(), ckpt)
    state, _ = restore_sharded_snapshot(_sharded_config(), 2, ckpt, **kw)
    return state.tick.device


def _live_reshard(tmp_path, **kw):
    from repro_torch.data.stream import QueryEvents
    from repro_torch.distributed.elastic import live_reshard
    from repro_torch.streaming.log import FirehoseLogWriter
    from repro_torch.core.hashing import join_fp
    s_hi, s_lo, q_hi, q_lo, src, valid = _hose()
    w = FirehoseLogWriter(str(tmp_path / "log"))
    w.append(0, QueryEvents(join_fp(s_hi, s_lo), join_fp(q_hi, q_lo), src,
                            valid), None)
    w.close()
    state, stats = live_reshard(_sharded_config(), _sharded_state(), 4, 4,
                                log_dir=str(tmp_path / "log"), **kw)
    assert stats["replayed_ticks"] == 1
    return state.tick.device


@pytest.mark.parametrize("entry", [
    _init_sharded_state, _sharded_hose_step("make_sharded_step"),
    _sharded_hose_step("make_sharded_tick_step"),
    _sharded_hose_step("make_sharded_ingest_many"), _make_sharded_decay,
    _make_sharded_rank, _restore_sharded_snapshot, _live_reshard],
    ids=lambda f: f.__name__.lstrip("_"))
def test_sharded_entry_points_default_to_cuda_and_refuse_without_it(
        monkeypatch, tmp_path, entry):
    """The sharded engine's entry points and ``live_reshard`` run on CUDA
    unless the caller asks for the CPU, and raise where CUDA is absent."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry(tmp_path / "cuda")
    assert entry(tmp_path / "cpu", device="cpu").type == "cpu"


def _lm_batch_fn(tmp_path, **kw):
    from repro_torch.launch.train import make_batch_fn
    cfg = _smoke_lm()
    return make_batch_fn(cfg, "lm", 2, 8, **kw)(0)["tokens"].device


def _recsys_batch_fn(tmp_path, **kw):
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import make_batch_fn
    cfg = get_arch("bert4rec").smoke_config
    return make_batch_fn(cfg, "recsys", 4, 8, **kw)(0)["items"].device


def _gnn_batch_fn(tmp_path, **kw):
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import make_batch_fn
    cfg = get_arch("gat-cora").smoke_config
    return make_batch_fn(cfg, "gnn", 4, 8, **kw)(0)["x"].device


def _train_run(tmp_path, device=None):
    from repro_torch.launch import train
    argv = ["--steps", "1", "--batch", "2", "--seq", "8", "--ckpt-dir",
            str(tmp_path)] + (["--device", device] if device else [])
    return train.run(argv, log=lambda s: None)["params"].embed.device


def _train_main(tmp_path, device=None):
    from repro_torch.launch import train
    argv = ["--steps", "1", "--arch", "bst", "--batch", "2", "--ckpt-dir",
            str(tmp_path)] + (["--device", device] if device else [])
    assert train.main(argv) == 0
    return torch.device(device)


@pytest.mark.parametrize("entry", [_lm_batch_fn, _recsys_batch_fn,
                                   _gnn_batch_fn, _train_run, _train_main],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_training_entry_points_default_to_cuda_and_refuse_without_it(
        monkeypatch, tmp_path, entry):
    """The trainer and its batches run on CUDA unless the caller asks for
    the CPU, and raise where CUDA is absent."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry(tmp_path / "cuda")
    assert entry(tmp_path / "cpu", device="cpu").type == "cpu"


# Every public name of the JAX package that the port leaves out, with why:
# "by design: ..." or the ROADMAP Queue 1 item that ports it. A file's key
# stands for every name in it, a class's for its methods. An entry the port
# defines must be a stub that raises NotImplementedError naming its item.
LEFT_OUT = {
    "core/engine.py:EngineConfig.kernel_on":
        "by design: on CUDA the kernel is the only path",
    "core/ranking.py:RankConfig.kernel_on":
        "by design: on CUDA the kernel is the only path",
    "core/engine.py:ingest_queries_stack":
        "by design: the port's engine holds no plan (Queue 3, 'What the "
        "plan means in the port')",
    "launch/autotune.py:tune_engine_config":
        "by design: the port's engine holds no plan",
    "launch/autotune.py:BLOCK_ROWS_CANDIDATES":
        "by design: the port's engine holds no plan",
    "launch/autotune.py:INGEST_FUSE_CANDIDATES":
        "by design: the port's engine holds no plan",
    "kernels/__init__.py:resolve_interpret":
        "by design: Pallas interpret mode",
    "kernels/__init__.py:kernels_native": "by design: Pallas interpret mode",
    "kernels/__init__.py:KERNEL_NATIVE_BACKENDS":
        "by design: Pallas interpret mode",
    **{f"kernels/decay_prune.py:{n}": "by design: a Pallas tile constant"
       for n in ("LANE", "SUBLANE", "ROWS_PER_BLOCK", "TILE")},
    "kernels/edit_distance.py:PAIR_BLOCK": "by design: a Pallas tile constant",
    "kernels/flash_attention.py:MIN_LANE": "by design: a Pallas tile constant",
    "kernels/flash_attention.py:NEG_INF": "by design: a Pallas tile constant",
    **{f"models/recsys.py:{c}.jdtype": "by design: a JAX dtype property"
       for c in ("BSTConfig", "XDeepFMConfig", "Bert4RecConfig",
                 "TwoTowerConfig")},
    "models/gnn.py:GATConfig.jdtype": "by design: a JAX dtype property",
    "models/transformer.py:LMConfig.jdtype": "by design: a JAX dtype property",
    **{f"models/{m}.py:Params": "by design: a JAX pytree alias"
       for m in ("gnn", "layers", "moe")},
    "models/layers.py:init_attention":
        "by design: the port builds nn.Modules",
    "models/layers.py:init_swiglu": "by design: the port builds nn.Modules",
    "distributed/sharding.py": "14.4b",
    "distributed/elastic.py:validate_divisibility": "14.4b",
    "distributed/elastic.py:reshard_for_mesh": "14.4b",
    "training/grad_compression.py:compressed_psum": "14.4b",
    "launch/mesh.py:make_production_mesh": "14.6",
    "launch/mesh.py:ICI_BW_PER_LINK": "14.6",
    "launch/dryrun.py": "14.7",
    **{f"launch/roofline.py:{n}": "14.7"
       for n in ("Roofline", "analyze", "collective_bytes", "shape_bytes",
                 "fusion_aware_bytes")},
}
ITEMS = {"14.4b", "14.6", "14.7"}


def _public_names(path: Path):
    """{name: node} of a module's public top-level functions, classes,
    constants, and the public methods of its public classes."""
    out = {}
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out[node.name] = node
            if isinstance(node, ast.ClassDef):
                for m in node.body:
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        out[f"{node.name}.{m.name}"] = m
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = node
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out[node.target.id] = node
    return {n: v for n, v in out.items()
            if not any(p.startswith("_") for p in n.split("."))}


def _raises_not_implemented(node) -> bool:
    return any(isinstance(n, ast.Raise) and "NotImplementedError"
               in ast.unparse(n.exc) for n in ast.walk(node))


def test_every_public_name_of_the_jax_package_is_ported_or_listed():
    """Parsed, neither package imported: each public name of
    ``src/repro/`` exists in ``src/repro_torch/`` or is in LEFT_OUT, and
    LEFT_OUT holds no name the port has (bar a stub naming its item)."""
    jax_root, port_root = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
    missing, listed_present = [], []
    for jpath in sorted(jax_root.rglob("*.py")):
        rel = jpath.relative_to(jax_root).as_posix()
        tpath = port_root / rel
        if not tpath.exists():
            if rel not in LEFT_OUT:
                missing.append(rel)
            continue
        assert rel not in LEFT_OUT, f"{rel} is ported; take it out of LEFT_OUT"
        ported = _public_names(tpath)
        for name in _public_names(jpath):
            key = f"{rel}:{name}"
            owner = f"{rel}:{name.split('.')[0]}"
            if key in LEFT_OUT or (owner in LEFT_OUT and owner != key):
                if name in ported:
                    listed_present.append((key, ported[name]))
            elif name not in ported:
                missing.append(key)
    assert not missing, f"not ported and not in LEFT_OUT: {missing}"
    for key, node in listed_present:
        assert LEFT_OUT[key] in ITEMS and _raises_not_implemented(node) \
            and LEFT_OUT[key] in ast.unparse(node), \
            f"{key} is in the port; take it out of LEFT_OUT"


@pytest.mark.parametrize("key", sorted(LEFT_OUT))
def test_every_left_out_name_exists_in_jax_and_says_why(key):
    rel, _, name = key.partition(":")
    path = ROOT / "src" / "repro" / rel
    assert path.exists(), key
    if name:
        assert name in _public_names(path), key
    why = LEFT_OUT[key]
    assert why in ITEMS or why.startswith("by design: "), key
