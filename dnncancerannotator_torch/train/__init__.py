'''Loss, learning-rate schedule and optimizer of the training step.'''
