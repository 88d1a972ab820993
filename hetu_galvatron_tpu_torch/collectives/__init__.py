"""The collective-schedule IR, its synthesis, static verification and
α-β pricing (port of ``hetu_galvatron_tpu/collectives/``: ``ir.py``,
``synthesize.py``, ``verify.py``, ``pricing.py``). The search's
hierarchical dp pricing (``core/cost_model/cost.py``) ranks the
synthesized families with them. Emission (JAX ``emit.py``,
``reference.py``) needs ranks and is not ported yet."""
