"""The plain reference and the yardstick of work, beside the harness;
neither imports anything of the program under test."""
