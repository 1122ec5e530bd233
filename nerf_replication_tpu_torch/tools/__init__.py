"""On-card tools of the port (run them on the machine with the card)."""
