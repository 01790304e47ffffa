"""Training: the step and the single-process trainer."""
