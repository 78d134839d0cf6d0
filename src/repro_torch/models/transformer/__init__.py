"""The decoder-only LM family (``repro.models.transformer``): dense and
mixture-of-experts configurations."""
