"""Process groups for the many-rank solves: the wire (comm), the
split-phase reduction (overlap) and starting ranks (ranks)."""
