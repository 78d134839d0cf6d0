"""The decoder-only LM family (``repro.models.transformer``): dense
configurations only (no experts)."""
