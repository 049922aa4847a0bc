"""Serving (port of ``repro.serve``): the clustering request engine lives
in ``repro_torch.serve.cluster``, imported by callers (it pulls in the
whole solver stack). The reference's LM serving modules (``engine``,
``batching``, ``kvcache``) are not ported yet (ROADMAP queue A.9)."""
