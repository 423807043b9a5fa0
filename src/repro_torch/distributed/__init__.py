"""The port's distributed pieces; so far the straggler monitor."""
