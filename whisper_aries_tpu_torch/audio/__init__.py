"""Audio decode and the log-mel front-end."""
