"""What the traffic kinds and metric readers share."""
