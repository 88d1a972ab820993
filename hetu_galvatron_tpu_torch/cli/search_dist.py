"""Strategy-search launcher: ``python -m
hetu_galvatron_tpu_torch.cli.search_dist <config.yaml> [key=value ...]``.

Counterpart of ``hetu_galvatron_tpu/cli/search_dist.py``: ``main`` reads
the profiles named by ``search.*``, runs ``core/search_engine``'s
``SearchEngine`` for ``search.num_nodes * search.num_devices_per_node``
devices, writes the winning plan into ``search.output_config_path`` and
prints ``search done: max throughput <x> samples/s``; it exits 1 when no
plan fits the memory budget. ``search_plan_for_world`` runs the same
search for a given world at a settled global batch. The search is host
arithmetic: it needs no device.

Not ported: the calibration feed (``feed_calibrated_profile`` raises when
``observability.calibration_dir`` is set with ``search.use_calibrated``:
the calibration loop is ROADMAP item 10b), and the elastic re-plan of a
resume on another world size (``replan_for_world`` and
``_adapt_degrees``: the elastic path, ROADMAP item 15).
"""

from __future__ import annotations

import dataclasses
import glob
import os
import sys
from typing import Callable, Optional


def feed_calibrated_profile(args, world: int,
                            *, log: Callable[[str], None] = print) -> bool:
    """JAX points the search at the runtime-calibrated profile of
    ``observability.calibration_dir`` when ``search.use_calibrated`` is on;
    the port has no calibration loop yet. Returns False (nothing fed)
    when there is nothing to feed."""
    cal_dir = args.observability.calibration_dir
    if not args.search.use_calibrated or not cal_dir:
        return False
    raise NotImplementedError(
        f"observability.calibration_dir={cal_dir} with "
        "search.use_calibrated=1: the calibration loop is not ported yet "
        "(ROADMAP item 10b); set search.use_calibrated=0 to search on the "
        "profiled files")


def _engine(args, search_args):
    from hetu_galvatron_tpu_torch.core.search_engine.engine import (
        SearchEngine,
    )
    from hetu_galvatron_tpu_torch.utils.hf_config_adapter import (
        model_layer_configs,
        model_name,
    )

    engine = SearchEngine(
        search_args, mixed_precision=search_args.mixed_precision,
        default_dp_type=search_args.default_dp_type,
        pipeline_type=search_args.pipeline_type,
        # the static HBM gate (search.hbm_budget_gb) reads the model
        model_cfg=args.model)
    engine.set_model_info(model_layer_configs(args.model),
                          model_name(args.model),
                          model_type=args.model.model_type)
    engine.initialize()
    return engine


def search_plan_for_world(args, world: int, out_dir: str,
                          *, log: Callable[[str], None] = print
                          ) -> Optional[str]:
    """Run the search for ``world`` devices with the profiles configured on
    ``args``, the global batch settled to
    ``args.parallel.global_train_batch_size``; returns the written plan's
    path, or None when no plan fits."""
    sa = args.search
    os.makedirs(out_dir, exist_ok=True)
    feed_calibrated_profile(args, world, log=log)
    settled = args.parallel.global_train_batch_size
    if sa.settle_bsz > 0 and sa.settle_bsz != settled:
        log(f"elastic re-search: ignoring search.settle_bsz="
            f"{sa.settle_bsz} — the checkpoint's batch geometry "
            f"(global_bsz {settled}) must survive the topology change "
            "for the exact data-position replay")
    s2 = dataclasses.replace(sa, num_nodes=1, num_devices_per_node=int(world),
                             settle_bsz=int(settled),
                             output_config_path=out_dir)
    throughput = _engine(args, s2).optimize()
    if throughput <= 0:
        return None
    plans = sorted(glob.glob(os.path.join(out_dir, "galvatron_config_*.json")),
                   key=os.path.getmtime)
    log(f"elastic re-search: plan for {world} devices -> {plans[-1]} "
        f"(predicted throughput {throughput:.6f} samples/s)")
    return plans[-1]


def main(argv=None) -> int:
    from hetu_galvatron_tpu_torch.core.arguments import args_from_cli
    from hetu_galvatron_tpu_torch.utils.hf_config_adapter import (
        resolve_model_config,
    )

    args = args_from_cli(argv if argv is not None else sys.argv[1:],
                         mode="search")
    args = resolve_model_config(args)
    feed_calibrated_profile(
        args, args.search.num_nodes * args.search.num_devices_per_node)
    throughput = _engine(args, args.search).optimize()
    # fixed 8-decimal rounding, as JAX prints it
    print(f"search done: max throughput {throughput:.8f} samples/s")
    return 0 if throughput > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
