"""Fleet helpers shared by the host scheduler (the fleet engine itself
is not ported yet)."""
