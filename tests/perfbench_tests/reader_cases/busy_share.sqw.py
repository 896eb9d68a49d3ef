"""busy_share.sqw on the shared synthetic trace: 20 us of the row slice's 50
us busy."""

EXPECTED = 40.0
