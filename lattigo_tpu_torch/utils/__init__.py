"""Host-side helpers (number theory)."""
