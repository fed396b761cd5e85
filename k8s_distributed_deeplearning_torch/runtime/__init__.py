"""Host runtime: the gradient-fusion planner."""
