"""Applications expressed as task graphs."""
