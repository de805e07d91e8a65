"""One-off measurements on the card that the main path does not run."""
