"""Measurement scripts run on the card (``python3 -m
optimal_control_problem_tpu_torch.tools.<name>`` from the repository
root); nothing of the solver imports them."""
