"""Host-side rendering of the race state (pygame, imported lazily)."""
