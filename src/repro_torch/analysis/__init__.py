"""Runtime analysis of the port: the sanitizers behind
``ServeConfig.sanitize`` (:mod:`repro_torch.analysis.sanitize`).  The
reference's static linter (``repro.analysis.lint``, ``rules``) is not
ported: it already lints ``src/repro_torch`` with the rest of ``src/``."""
