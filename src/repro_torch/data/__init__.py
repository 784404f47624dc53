"""Input formats the port reads (NS Optimizer profiles) and the synthetic
token stream training reads (``synthetic``)."""
