"""Drivers: one general loop per kind of work, chosen by a traffic mix's
``driver`` key."""
