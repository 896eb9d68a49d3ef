"""busy_share.gs on the shared synthetic trace: 45 us of the groundstate
slice's 100 us busy."""

EXPECTED = 45.0
