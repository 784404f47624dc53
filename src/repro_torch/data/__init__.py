"""Input formats the port reads (NS Optimizer profiles)."""
