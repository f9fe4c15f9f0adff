"""Models and training loops."""
