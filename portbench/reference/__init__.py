"""The benchmark's plain reference: `algorithms` computes, and each other
module here compares one kind of answer (found by the name a workload's
`reference` gives). None imports the program under test."""
