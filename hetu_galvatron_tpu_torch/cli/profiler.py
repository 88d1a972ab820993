"""Model and hardware profiling launcher: ``python -m
hetu_galvatron_tpu_torch.cli.profiler <config.yaml>
mode=model_profiler|profile_hardware [key=value ...]``.

Counterpart of ``hetu_galvatron_tpu/cli/profiler.py`` (:10-33).
``mode=model_profiler`` runs ``core/profiler/model_profiler.ModelProfiler``
(``model_profiler.profile_type=computation|memory``) and
``mode=profile_hardware`` runs
``core/profiler/hardware_profiler.HardwareProfiler`` over the visible
devices. Both run on ``cuda`` unless ``device=cpu`` is given, and print
``wrote <name>: <path>`` for each file they write.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    from hetu_galvatron_tpu_torch.core.arguments import args_from_cli
    from hetu_galvatron_tpu_torch.utils.hf_config_adapter import (
        resolve_model_config,
    )

    argv = list(argv if argv is not None else sys.argv[1:])
    mode = "model_profiler"
    for a in argv:
        if a.startswith("mode="):
            mode = a.split("=", 1)[1]
    args = resolve_model_config(args_from_cli(argv, mode=mode))

    if args.mode == "profile_hardware":
        import torch

        from hetu_galvatron_tpu_torch.core.profiler.hardware_profiler import (
            HardwareProfiler,
        )
        from hetu_galvatron_tpu_torch.runtime.initialize import resolve_device

        cuda = resolve_device(args).type == "cuda"
        paths = HardwareProfiler(
            args.hardware_profiler,
            devices=torch.cuda.device_count() if cuda else 1).run_all()
    else:
        from hetu_galvatron_tpu_torch.core.profiler.model_profiler import (
            ModelProfiler,
        )

        paths = ModelProfiler(args).run()
    for name, path in paths.items():
        print(f"wrote {name}: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
