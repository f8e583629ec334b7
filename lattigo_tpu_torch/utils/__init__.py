"""Host-side helpers (number theory, double-double arithmetic)."""
