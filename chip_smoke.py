#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's two CUDA kernels from ``das4whales_tpu_torch/csrc`` with
``nvcc`` (sm_90a) and the native ingest reader from
``das4whales_tpu_torch/native/ingest.cpp`` with ``g++``, then runs
thirty-seven phases, one summary line each (more for the detector runs, with their
profiles), and exits non-zero at the first failed check; no phase's
failure is caught. The ``dsp`` and ``localize`` phases (on the canonical
block and design this process hands over), then the card-vs-CPU phases
but the learned and the mesh ones (numerics and contracts at 512
channels, timing nothing) run one after another in a spawned process
beside the card's phases after the ``gabor`` phase (``BESIDE_PHASES``);
a failure there fails the run when this process next looks, between two
of its phases, and that process ends before the ``mesh`` phase:

1. ``device``   the card's name and power limit (``nvidia-smi``), torch and
                CUDA versions, and which of h5py, pandas and matplotlib import
                here (printed, not required); no CUDA device -> exit 1,
                nothing else runs;
2. ``build``    the ``nvcc`` builds of ``csrc/fused_picks.cu`` and
                ``csrc/fused_stft.cu`` and the ``g++`` build of
                ``native/ingest.cpp``, started together, each one's seconds
                and ptxas line, then both kernels' registers and spills per
                instantiation (the main launches' must not spill);
3. ``kernels``  the fused pick kernel against its plain PyTorch version on
                the card, at the main path's shapes (1024 rows x 12000
                samples, ``pack`` K=64 and ``topk`` K=256) and on edge rows
                (plateaus, ties, K and K+1 candidates, every other sample a
                maximum, T = 40); all five outputs must be bitwise equal;
                a call's time by CUDA events (the kernel table's ``ms``),
                the device time a launch (profiler, ``device_ms``) and the
                host time a call, the bound, the CTAs an SM (at least the
                design's), and the phase split of the kernel's phase-timed
                instantiation;
4. ``detect``   ``MatchedFilterDetector.detect_picks`` on the canonical OOI
                block, 22050 channels x 12000 samples at 200 Hz, raw int32
                counts, the ``fin`` bank, injected calls: one warm-up, three
                timed runs, per-stage walls from CUDA events, launches and
                syncs; every injected call must be picked on its nearest
                channel within 1 s of its arrival;
5. ``full``     ``MatchedFilterDetector(...)(trace, with_snr=True)``, the
                flagship workflow's full-artifact call at its settings
                (sparse picks on the card, correlograms kept), on the
                ``detect`` phase's block and design: one warm-up, three timed
                runs, stage walls from CUDA events, 44 pick launches a run
                (88 with an escalation), syncs, peak memory, a profile; picks
                and thresholds bitwise ``detect_picks``' on the same detector,
                ``trf_fk`` bitwise ``filter_block``'s, correlograms finite,
                the SNR without NaN or +inf, every injected call picked, the
                pick kernel bitwise its plain version at the route's first
                and last launch; then ``pick_mode="dense"`` at 512 x 12000:
                picks and peak masks equal the sparse route's;
6. ``full_cpu_vs_card`` the same call on the card against ``device="cpu"``
                at 512 x 12000: thresholds rtol 1e-5, ``trf_fk`` and
                correlograms within 1e-4 * max, the SNR within 0.01 dB where
                it lies within 60 dB of its max, picks up to knife edges;
7. ``channel_pad`` the canonical block on a design padded to 22500
                channels (``channel_pad="auto"``): ``filter_block`` padded and
                unpadded by CUDA events in turns, ``detect_picks`` walls and
                stage walls of both, every injected call picked padded;
8. ``bank``     ``detect_picks`` with the ``fin-variants`` bank (4 templates,
                per-template thresholds) on the canonical block: wall, stage
                walls, 44 pick launches of 2048 rows, the kernel bitwise its
                plain version at the first and last launch, every injected
                call picked, and the ``split_views`` halves' picks and
                thresholds bitwise the full bank's rows;
9. ``cpu_vs_card`` the port on the card against the port on the CPU at
                512 x 12000 (thresholds to rtol 1e-5, picks equal up to
                rounding knife edges), at the defaults and with the K0
                escalation and the capacity overflow forced;
10. ``stft_kernel`` the fused STFT-power kernel against its plain PyTorch
                version and against ``torch.stft`` power on the card, at the
                main path's launch (4096 x 12000, nfft 160, hop 8, centred)
                and on edge cases (1570 channels, T = 11963, center=False,
                window="ones", hop = nfft, T < nfft, spans past 48 KB at
                nfft 1024 and 2048, odd nfft 65, nfft 162 with no
                self-paired bin); each within 5e-6 * max|reference|; times
                (a call, and the device time a launch), the bound and the
                dense and folded DFT forms;
11. ``spectro``  ``SpectroEvalAdapter(MatchedFilterDetector.from_design(...),
                SpectroCorrDetector(meta))`` on the ``detect`` phase's scene,
                conditioned on the host: one warm-up, three timed runs,
                stage walls from CUDA events, 12 STFT-kernel launches and the
                device->host reads per run, a profile; every injected call
                must be picked (by either hat kernel) on its nearest channel
                within 1 s of its arrival;
12. ``spectro_cpu_vs_card`` the spectro family on the card against the CPU
                at 512 x 12000, both bandpass modes: correlograms within
                1e-4 * max|cpu|, picks equal up to rounding knife edges;
13. ``slab``     the batched ingest route at the campaign's defaults: five
                Silixa TDMS files (four 22050 x 12000, one 22050 x 11000,
                raw int32; the card's machine has no ``h5py``) written by
                the port, streamed by ``stream_batched_slabs`` (batch 4,
                pow2 buckets, the format reader, conditioned wire) into [4, 22050, 16384] slabs through
                pinned memory on a side stream, and detected by
                ``BatchedMatchedFilterDetector.dispatch_batch(...,
                with_health=True)`` in the batched and the serial mode (a
                timed pass each, the batched mode after a warm-up pass, the
                serial mode after one noise slab); per file the picks
                must equal ``detect_picks`` on the same card (serial:
                bitwise; batched: thresholds within 1 ulp), every injected
                call be picked, the health show 0 non-finite, 0 clipped,
                rms within 1e-5 of float64 and no breach; one read per
                attempt, 44 pick launches a tile sweep (batched: per slab;
                serial: per file), peak device memory under 80 GB; in each
                mode the pick kernel against its plain version, all five
                outputs bitwise for ``pack`` K=64 and ``topk`` K=256, on
                the inputs the route gave its first and last launch of
                the first slab (batched: 4096 and 272 rows x 16384, the
                files' own thresholds), and its CTAs an SM at 16384
                samples (the design's, or as many as the shared memory
                holds); it prints
                the slab's detect wall, its stages (the health stage among
                them) and busy share, per-file read and conditioning
                seconds, the copy's ms, GB/s and bytes, the pass's wall
                against the sum of its parts, the batched pass again with
                the native reader, and the stream alone on the native
                engine, both wires (the host's read ceiling);
14. ``slab_cpu_vs_card`` the slab route on the card (batched mode) against
                the CPU (serial mode) at 512 channels, both wires, batch 2,
                a clip level, and a float32 file with 3 NaNs and 5 samples
                at the clip (on the raw wire it flushes a partial slab):
                thresholds within rtol 1e-5, picks equal up to knife
                edges, health counts equal, the float32 file alone
                breaching; ``stream_strain_blocks`` on the card against
                the host read, bit for bit; then ``BatchedSpectroDetector``
                on one slab against its adapter file by file on the card,
                its ``fused_stft`` launches counted (one a hat kernel and
                4096-channel chunk) and the kernel held against its plain
                version within 5e-6 * max on the facade's own launch
                (1024 x 16384);
15. ``campaign`` ``run_campaign_batched`` at its defaults (batch 4, pow2
                buckets, conditioned wire, the format reader, the mf
                family, health, dispatch depth 2) over the slab phase's
                five files, ``interrogator="silixa"``: every file ``done``
                at ``batched:4`` with no downshift event, 44 ``fused_picks``
                launches and one read an attempt, each file's saved picks
                bitwise the slab phase's batched picks, every injected call
                picked; then the same call again (resume) settles nothing
                and reads nothing, ``summarize_campaign`` counts 5 done and
                ``fsck_outdir`` finds nothing (on the slab phase's design
                of the bucket, ``design=``, where that phase ran). It
                prints the pass a file, the bucket's detector seconds, the
                picks-artifact and
                manifest write seconds, the peak device memory and the busy
                share of one slab of the campaign's facade (profiler);
16. ``campaign_cpu_vs_card`` both entries at 512 x 12000 on the card
                against ``device="cpu"`` (five int32 files, a corrupt and a
                NaN file; records equal file by file — status, rung,
                attempts — picks equal up to knife edges); a pinned
                ``FaultPlan``: an oom at ``batched:4`` that fits from
                ``batched:2`` (one downshift; serial mode: picks bitwise
                the fault-free run's), a corrupt file ``failed``, a NaN
                file ``quarantined``; a wedged dispatch under
                ``dispatch_deadline_s`` (``timeout`` for that file only);
                the spectro family on one slab (``fused_stft`` launches,
                picks equal to ``BatchedSpectroDetector``'s); and a design
                saved by the port and loaded again (bitwise the same
                picks); a ``fin-variants`` campaign whose full-bank slab
                program is refused: ``batched:2 -> bank:2``, every file done
                there with the healthy run's picks bit for bit, on the card
                and on the CPU;
17. ``gabor``    the Gabor/image family at ``main_gabordetect.py``'s settings
                (c0 1500 m/s, bin 0.1, ksize 100, thresholds 9100 / 150, HF
                and LF notes, the ``"fft"`` engine) on the ``detect`` phase's
                block, conditioned on the host, through
                ``gabordetect.campaign_detector(..., design=)``: one
                warm-up, three timed runs, stage walls from CUDA events
                (prefilter, trace2image, binning, the two Gabor scores, the
                upsample and smooth, the masked matched filter, the picks), 2
                ``fused_picks`` launches a call (+1 a note that escalates),
                syncs, peak memory, a profile; the pick kernel bitwise its
                plain version at the route's first and last launch; every
                injected call picked (where the reference's thresholds miss
                one, the phase says so and runs the thresholds a JAX CPU run
                keeps every call at); the ``"conv"`` engine once, its score
                within 1e-5 * max of ``"fft"``'s, walls in turns; the
                batched facade's peak at [4, 22050, 16384] (a smaller B where
                the card runs out); ``run_campaign_batched(family="gabor")``
                over two of the slab files of 12000 samples (a partial slab
                at batch 4): every file done, the rung that served, every
                call picked;
18. ``gabor_cpu_vs_card`` the Gabor family on the card against
                ``device="cpu"`` at 512 x 12000 on one design and one set of
                notes: score and correlograms within 1e-4 * max|cpu|, binary
                image and mask equal up to counted knife edges, picks up to
                knife edges; ``run_campaign_batched`` (batch 2) and
                ``run_campaign`` with ``family="gabor"`` over three TDMS
                files on both devices, manifests equal record by record
                (less wall times, span ids and pick counts), picks up to
                knife edges, every injected call picked;
19. ``learned``  the learned CNN family on the ``detect`` phase's block,
                conditioned on the host, through ``family_detector("learned",
                ...)`` with the pretrained ``fin_cnn`` at full width: one
                warm-up, three timed runs, stage walls from CUDA events
                (stft, features, cnn, finalize), exactly one ``fused_stft``
                launch and one read a call, the kernel within 5e-6 * max of
                its plain version at the route's launch, peak memory, every
                injected call picked, a profile; the kernel alone at this
                shape (22050 x 12000, nfft 128, hop 32) beside its plain
                version, ``torch.stft`` + power and its bound; the tiled view
                against the one-program sweep; ``BatchedLearnedDetector`` at
                [4, 22050, 12000] serial (picks bitwise the per-file calls')
                and batched (scores within 1e-5, picks up to knife edges),
                with its peak and the kernel held again at the slab's launch;
                ``run_campaign_batched`` (batch 4) and ``run_campaign`` with
                ``family="learned"`` over the slab files of 12000 samples
                (``run_campaign`` over two of them):
                every file done at ``batched:4`` / ``file`` (or the rung
                served named), every call picked, one launch a slab / a file,
                records equal to the same campaigns on the CPU over every
                40th channel, those channels' picks up to knife edges;
20. ``learned_cpu_vs_card`` the card's full-width scores on the channels
                near the calls against ``device="cpu"`` on the same rows
                (within 1e-5, picks up to knife edges); ``fit`` on JAX's test
                scenes (2 x 32 x 3000, 25 epochs) on the card and on the CPU:
                loss histories within 1e-3 (relative), the card's model
                picking the held-out scene's calls;
21. ``dsp``      the reference DSP API on the canonical block, conditioned:
                ``bp_filt`` (fft), ``taper_data``, ``instant_freq``,
                ``fk_filter_apply`` against ``fk_filter_apply_rfft`` (within
                1e-5 * max), a call's wall each by CUDA events; the exact
                IIR (``sosfiltfilt_chunked``, ``bp_filt(mode="exact")``) in
                float64 at full width (fewer channels, printed, where a
                probe predicts more than 60 s), against scipy on 64
                channels; the five f-k designers' and fk_filt's speed fan's
                host seconds at 22050 x 3000, in spawned processes beside
                phases 27, 28 and 34 and printed after 30;
22. ``localize`` detect -> localize -> evaluate: a 22050 x 12000 scene with
                three off-cable calls (|y0| 300 m to 3 km, z0 -20 m), the
                matched filter's ``__call__`` (44 ``fused_picks`` launches,
                the kernel bitwise its plain version at the first and last
                launch), ``localize_scene_call`` for each call within JAX's
                ``test_detect_localize`` bounds (x 20 m, |y| 100 m, t0
                0.05 s, residual rms 0.02 s), ``evaluate_detector`` with
                recall 1.0 on the cells clear of the f-k fan's taper and
                the channel wrap (the whole-footprint recall printed
                beside it), and ``localize_batch`` of 4096 events in
                float64, 256 of them against the CPU within rtol 1e-9;
23. ``longrecord`` ``detect_long_record`` over two consecutive 22050 x 12000
                int32 TDMS files with a call straddling the boundary: the
                matched filter on both wires (the record's design made in a
                spawned process beside phases 27, 28 and 34), the straddling call
                picked on both and their picks equal, no pick kernel launch
                (the plain tiled picker, as JAX's route); ``detect_picks``
                file by file beside it and the correlogram peaks that show
                the straddle weakened; the learned family over the record:
                one ``fused_stft`` launch within 5e-6 * max of its plain
                version, its peak; the spectro and Gabor families over the
                same record at full width on a mesh of one (the halo
                bandpass, the pencil f-k on the record's own mask, their
                time-split steps), the straddling call picked by both, the
                Gabor step's ``fused_picks`` launch bitwise its plain
                version;
24. ``dsp_cpu_vs_card``, 25. ``localize_cpu_vs_card``, 26.
                ``longrecord_cpu_vs_card`` the three at 512 channels on the
                card against ``device="cpu"``: FFT ops within 1e-5 * max,
                the exact IIR in float64 within 1e-10, thresholds rtol
                1e-5, picks up to knife edges, ``loc`` in float64 within
                rtol 1e-9;
27. ``preflight`` the memory preflight's probe (``utils.memory``: a zero
                slab, the peak above it, memoized) of the mf facade at
                [B, 22050, 16384] (conditioned, health, the campaign
                phase's design, its escalation attempt) and the learned
                facade at [B, 22050, 12000], B = 1, 2, 4: each peak and
                probe's seconds, peaks growing with B; then
                ``run_campaign_batched(preflight=True)`` over the slab
                files with ``DAS_HBM_BUDGET_GB`` between the mf B=2 and
                B=4 peaks: one preflight downshift to ``batched:2``,
                every file done there, no out-of-memory error, picks
                bitwise a run at batch 2 without the preflight;
28. ``service``  a ``DetectionService`` on the card with tenants ``mf``
                (batch 4, pow2, health, a share between its B=2 and B=4
                peaks: admission pins ``batched:2`` before its first
                dispatch) and ``learned`` (``fin_cnn``, exact, batch 4)
                over the four 22050 x 12000 slab files, SLO, quality and
                cost cards on, a client polling /livez, /readyz,
                /metrics, /tenants, /slo, /quality and /picks (cursor
                resume), all 200: every file done at its rung, each
                tenant's picks bitwise its standalone
                ``run_campaign_batched``, every injected call picked, no
                lock-order inversion, peak memory under 80 GB, both
                kernels launched on the route and held against their plain
                versions at its first and last launch; the pass walls,
                pick latency p95, admission seconds and cost cards, each
                card's program-contract verdict ``clean`` (recorded on the
                preflight phase's probes); and
                ``python -m das4whales_tpu_torch serve --until-idle`` as a
                subprocess over one file a tenant, run beside the
                fleet phase: exit 0, both manifests settled;
29. ``service_cpu_vs_card`` the same two-tenant service at 512 x 12000 on
                the card and with ``device="cpu"``: records equal (status,
                rung, attempts), mf picks up to knife edges, learned
                scores within 1e-5 and picks up to knife edges;
30. ``mxu``      the matmul engines (``ops.mxu``) on the canonical block, on
                a calibration table of the run's own: each A/B calibration's
                seconds and verdict (correlate, correlate-fused, f-k at 4096
                channels, STFT at 4096 x 12000 nfft 160 hop 8 with
                ``fused_stft`` launched as its "fused" candidate and held
                against its plain version; f-k ``auto`` at 22050 channels
                must say FFT, above the cap), both precision gates' verdicts
                and reasons, the matmul STFT's time; ``detect_picks`` on the
                FFT route and on ``matmul``, ``matmul`` + f-k ``matmul``,
                the forced ``matmul-bf16`` and ``matmul-fused`` (whatever
                their gates resolve) and ``auto``: median wall of 3 after a
                warm-up, stage walls, 44 pick launches and one read an
                attempt, the pick kernel bitwise its plain version at the
                route's first and last launch, peak memory, every call
                picked, envelopes, thresholds and picks against the FFT
                route's at fixed bounds (float32 engines: envelopes
                within 1e-4 * max, thresholds rtol 1e-5, picks up to
                1e-5 knife edges; bf16: 2**-7 * max and rtol 2**-7, its
                knife margin implied by that bound; the tap-fold judged
                at least its FIR half-length from the ends), the bf16
                route's correlograms float32 and TF32 off after every run; the full route on
                ``matmul`` once (picks bitwise ``detect_picks``'); a second
                ``auto`` detector on the same table making no measurement;
                the batched facade on ``matmul`` at [4, 22050, 16384] (a
                smaller B where the card runs out);
31. ``mxu_cpu_vs_card`` each forced engine on the card against
                ``device="cpu"`` at 512 x 12000: the contraction on one
                filtered block within 1e-4 * max; end to end correlograms
                and envelopes within 1e-4 * max (bf16: 1e-3 * max),
                thresholds rtol 1e-5 (bf16: 1e-3), picks up to 1e-5 knife
                edges (bf16: the margin its bound implies) where both
                resolved the same engine, the gate verdicts side by side
                (a difference is reported, not failed);
32. ``workflows`` the workflow mains as a user calls them: the flagship
                ``workflows.mfdetect.main(path, interrogator="silixa")`` at
                22050 x 12000 on a canonical Silixa TDMS file (raw int32,
                the canonical six calls, seed 2026) in a spawned process that
                runs beside the card's phases after ``gabor`` (its f-k
                design takes tens of seconds of host): stage walls, 44
                ``fused_picks`` launches an attempt bitwise plain at the first
                and last, peak memory, every injected call picked, then the
                detection figure's envelope (``viz.plot.envelope_np``);
                then, in the same process, ``spectrodetect``, ``gabordetect``,
                ``fkcomp``, ``plots`` and ``bathynoise`` at 2048 x 12000:
                walls and launches, both
                kernels held against their plain versions at their first and
                last launch, every call picked where the family picks,
                bathynoise's stats against float64 on the host; and ``python
                -m das4whales_tpu_torch`` as subprocesses (on a thread beside
                the same phases): ``list``, ``evaluate --family mf``,
                ``longrecord --interrogator silixa``, ``mfdetect --outdir`` and
                ``campaign`` at 2048 channels (their PNG files, JAX's names;
                where matplotlib is missing both must exit 2 naming it before
                reading the file), ``fsck``;
33. ``workflows_cpu_vs_card`` each main at 512 x 12000 on the card against
                ``device="cpu"``: thresholds rtol 1e-5, ``trf_fk``, the
                envelopes the detection figures draw, the spectrogram (its
                linear magnitude), the f-x panels (on one input) and fkcomp's
                filtered blocks within 1e-5 * max, fkcomp's SNR within 0.01 dB where within
                60 dB of its max, bathynoise's mean and std within 1e-5
                relative, its median within 1e-5 relative or within its row's
                largest envelope difference (an order statistic moves no more
                than the samples do), its dB within 1e-3, picks up to knife
                edges; the
                ten image ops of ``ops.image`` on the Gabor family's binned
                image within 1e-5 * max (Radon 1e-4), Canny up to counted
                knife edges, Hough equal on the same edge map;
34. ``fleet``    (run right after 28) the self-healing fleet: a
                ``FleetSupervisor`` here spawns two ``python -m
                das4whales_tpu_torch serve`` workers on the one card, each
                with a ``DAS_HBM_BUDGET_GB`` share between the preflight's mf
                B=2 and B=4 peaks, and places two mf tenants (batch 2, pow2,
                the four 22050 x 12000 slab files each, one design
                checkpoint, paced replay) one a worker; a client streams both
                tenants' picks through the ``FleetRouter`` with cursors; one
                graceful migration with a first slab in flight, then, once
                both first slabs settled, a SIGKILL of the worker holding
                both tenants: every file
                done once at ``batched:2``, picks bitwise the preflight's
                standalone batch-2 campaign (the kernel's launches there
                held bitwise against its plain version), cursor streams
                without gaps or duplicates, ``fsck_outdir`` clean, no tmp
                left, ``fleet.jsonl`` replaying to the final assignment, the
                router's ``/fleet``, worker-labelled ``/metrics``, ``/livez``
                and ``/readyz`` 200, the survivor's exit 0 and no worker left
                running, the service phase's 88 ``fused_picks`` launches; the
                spawn, migration and recovery walls, each worker's device
                memory (``nvidia-smi``) and the launches its slab counters
                imply;
35. ``mesh``     (run right after 23) the matched filter over a device mesh:
                two rank processes of this script (``--mesh-rank``) share the
                card over gloo (NCCL refuses two ranks on one device), each
                on its own slice: (1) ``make_sharded_mf_step(wire="raw")``
                through the campaigns' adaptive pair at (file=1, channel=2)
                on the raw canonical block, 22 ``fused_picks`` launches a rank
                and attempt, each rank's first and last launch bitwise its
                plain version, picks equal ``detect_picks`` up to knife
                edges, thresholds rtol 1e-5, ``outputs="full"``'s gathered
                ``trf_fk`` within 1e-5 * max of ``filter_block``'s; (2) the
                same step on a one-rank NCCL group; (3) the long record over
                (time=2), the fused bandpass at full width held to the
                ``longrecord`` phase's picks (the plain picker's route) up to
                knife edges, its picks through ``fused_picks`` (22 launches a
                rank, the first and last bitwise plain), the halo bandpass on
                the ``MESH_HALO_CHANNELS`` channels around the straddling
                call, which both pick; (4) ``run_campaign_sharded`` at (file=2,
                channel=1) over ``MESH_CAMPAIGN_FILES`` slab files: every file
                done, picks equal ``detect_picks`` at the files' shape up to
                knife edges, only rank 0 writing, ``fsck_outdir`` clean, a
                resume reading nothing; (5) ``python -m das4whales_tpu_torch
                campaign --sharded`` as a subprocess without rank variables at
                2048 channels against the one-device detector's
                ``detect_picks`` on the same design; the families (ROADMAP
                14b): (6) ``make_sharded_spectro_step`` at (file=1,
                channel=2) on the prefiltered canonical block, each rank's
                ``fused_stft`` launches (one a 256-channel tile) counted and
                its first and last held within 5e-6 * max of plain, picks
                equal the one-card ``SpectroCorrDetector``'s up to knife
                edges; (7) ``make_sharded_gabor_step`` at (file=2) on two
                prefiltered slab files, one ``fused_picks`` launch a rank
                bitwise plain, picks equal ``GaborDetector``'s up to knife
                edges; (8) the learned long record over the mesh
                (``make_sharded_inference`` at (channel=2), full width)
                against the same scoring on one card; (9) the spectro long
                record over (time=2) on ``MESH_SPECTRO_CHANNELS`` channels
                around the straddling call and (10) the Gabor long record on
                its first ``MESH_GABOR_CHANNELS`` rows (22050 fail the
                binning grain at P = 2), each against the same record on a
                mesh of one on the card up to knife edges, the straddling
                call picked, the Gabor launches bitwise plain. It prints
                each collective's bytes, wall and host-staging share and
                each rank's peak; a rank that dies fails the phase, naming
                it and its log; budget ``MESH_BUDGET_S``;
36. ``mesh_cpu_vs_card`` item 1's step at 512 x 12000, two card ranks against
                two gloo CPU ranks at once: thresholds rtol 1e-5, ``trf_fk``
                and correlograms within 1e-4 * max, picks up to knife edges;
                budget ``MESH_CPU_BUDGET_S``;
37. ``analysis`` (run inside 4, while it waits for the early host jobs and
                the card is idle) the port's own analyzer: the static
                gate (``python -m das4whales_tpu_torch.analysis --check``
                on this machine's Python) must exit 0; the canonical program
                variants (five matched-filter engine pairs at 24 x 900, the
                spectro, Gabor and learned facades at 16 x 2000) recorded on
                the card through the memory preflight's probe, audited
                clean against the checked-in ``analysis/contracts.json``,
                each stream's ``kernel:*`` entries equal to the launches
                ``torch.profiler`` saw and the wrappers counted; the
                contract gate on and off over a batch-2 campaign of mf and
                of learned at 512 x 12000: picks bitwise, cards ``clean``
                against ``unchecked``, measured peaks equal; the canonical
                mf probe at B=1 recorded and not, in turns (the recording's
                cost on the cold wall, peaks equal); a second
                ``detect_picks`` at the canonical shape probing and building
                nothing; both kernels' first and last launch in the phase
                held against their plain versions (picks bitwise, STFT
                within 5e-6 * max); its seconds against a 30 s target.

Then it prints each phase's seconds, the kernel table as one JSON line, the run's total
seconds, the ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``. It imports no JAX and nothing
of the JAX package. ``--only PHASE[,PHASE]`` runs the named phases after
``device`` and ``build``, for development; it prints no result line.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import json
import os
import statistics
import subprocess
import sys
import time
import types

import numpy as np

#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32
#: (non-tensor-core) operations/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SMS = 132

CANONICAL = (22050, 12000)
SEED = 2026


def fail(msg: str) -> None:
    print(f"FAIL {msg}", flush=True)
    sys.exit(1)


def say(line: str) -> None:
    print(line, flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("device: torch.cuda.is_available() is False; this script runs on a CUDA card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"device: nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    _SMI["line"] = smi_line
    say(f"device: {smi_line} | torch {torch.__version__} | CUDA {torch.version.cuda} "
        f"| {torch.cuda.device_count()} device(s)")
    for name in ("h5py", "pandas", "matplotlib"):
        try:
            importlib.import_module(name)
            _PKGS[name] = True
        except ImportError:
            _PKGS[name] = False
    say("device: packages on this machine: "
        + ", ".join(f"{k} {'imports' if v else 'missing'}" for k, v in _PKGS.items()))
    return smi_line


#: the card's ``nvidia-smi`` name and power limit, kept by ``phase_device``
_SMI: dict = {}
#: whether h5py, pandas and matplotlib import here, kept by ``phase_device``
_PKGS: dict = {}


KERNELS = ("fused_picks", "fused_stft")

#: the STFT kernel's instantiation at the main launch (1501 frames: R = 4
#: frames a thread; the span fits in shared memory)
STFT_MAIN_INSTANCE = (4, True)

#: the pick kernel's instantiation at the main launch (pack, untimed, the
#: shared-memory form), and the CTAs an SM its design holds for each method
#: at the main launch's row length (pack K=64, topk K=256)
PICKS_MAIN_INSTANCE = (0, False, False)
PICKS_CTAS_PER_SM = {"pack": 4, "topk": 3}

#: an H100 SM's shared memory for resident CTAs, and what CUDA reserves of
#: it for each CTA (the occupancy calculator's sharedMemPerMultiprocessor
#: and reservedSharedMemPerBlock)
SM_SMEM_BYTES = 228 * 1024
CTA_RESERVED_SMEM = 1024


def ptxas_instances(report: str, kernel: str) -> dict:
    """``{template arguments: (registers, spill store bytes, spill load
    bytes)}`` for each instantiation of ``kernel`` in an ``nvcc -Xptxas -v``
    report; int arguments read as ints, bool ones as bools."""
    import re

    out, cur, spill = {}, None, (0, 0)
    for line in report.splitlines():
        m = re.search(rf"Compiling entry function '\S*{kernel}I((?:L[ib]\d+E)+)E", line)
        if m:
            cur = tuple(v == "1" if t == "b" else int(v)
                        for t, v in re.findall(r"L([ib])(\d+)E", m.group(1)))
            spill = (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            out[cur] = (int(m.group(1)),) + spill
            cur = None
    return out


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from das4whales_tpu_torch.io import native
    from das4whales_tpu_torch.utils import build

    # one nvcc per source and the g++ of the native reader, all started together
    with ThreadPoolExecutor(len(KERNELS) + 1) as pool:
        ingest = pool.submit(native.build)
        built = list(pool.map(build.build, KERNELS))
        so = ingest.result()
    if not native.available():
        fail(f"build: the native ingest library {so.name} built but does not load")
    say(f"build: native/ingest.cpp -> build/native/{so.name} in {native.build_seconds:.2f} s "
        f"(g++ {' '.join(native.GXX_FLAGS)})")
    for name, (path, seconds, report) in zip(KERNELS, built):
        ptxas = " ".join(l.strip() for l in report.splitlines() if "registers" in l or "smem" in l)
        fma = "-fmad=false" if "-fmad=false" in build.nvcc_flags(name) else "FMA contraction on"
        say(f"build: csrc/{name}.cu -> {path.name} in {seconds:.2f} s "
            f"(nvcc sm_90a, {fma}; {ptxas or 'no ptxas report'})")
    inst = ptxas_instances(built[KERNELS.index("fused_stft")][2], "fused_stft_kernel")
    if STFT_MAIN_INSTANCE not in inst:
        fail(f"build: no ptxas report for fused_stft_kernel<{STFT_MAIN_INSTANCE}>: {inst}")
    say("build: fused_stft ptxas per instantiation (R, span): " + "; ".join(
        f"R={r} {'span' if sp else 'gather'}: {regs} registers, {st} B spill stores, "
        f"{ld} B spill loads" for (r, sp), (regs, st, ld) in sorted(inst.items())))
    if any(inst[STFT_MAIN_INSTANCE][1:]):
        fail(f"build: fused_stft_kernel<{STFT_MAIN_INSTANCE}>, the main launch's, spills")
    inst = ptxas_instances(built[KERNELS.index("fused_picks")][2], "fused_picks_kernel")
    if PICKS_MAIN_INSTANCE not in inst:
        fail(f"build: no ptxas report for fused_picks_kernel<{PICKS_MAIN_INSTANCE}>: {inst}")
    say("build: fused_picks ptxas per instantiation (template arguments): " + "; ".join(
        f"{args}: {regs} registers, {st} B spill stores, {ld} B spill loads"
        for args, (regs, st, ld) in sorted(inst.items())))
    if any(inst[PICKS_MAIN_INSTANCE][1:]):
        fail(f"build: fused_picks_kernel<{PICKS_MAIN_INSTANCE}>, the main launch's, spills")


def _kernel_modules() -> dict:
    from das4whales_tpu_torch.ops import fused_picks, fused_stft

    return {"fused_picks": fused_picks, "fused_stft": fused_stft}


def zero_launches() -> None:
    """Set every kernel's launch count to 0 (just before a main path)."""
    for mod in _kernel_modules().values():
        mod.launches = 0


def read_launches() -> dict:
    return {name: mod.launches for name, mod in _kernel_modules().items()}


def _cuda_ms(fn, reps: int) -> float:
    """Time of one call of ``fn``: CUDA events around ``reps`` calls in a
    row, after one warm-up. Where the host takes longer over a call than
    the card, this is the host's time a call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _edge_rows(T: int, rng) -> tuple:
    """Rows that exercise the kernel's corner cases, as (re, im, thr)."""
    rows = []
    # plateaus: quantised values repeat in runs of equal samples
    q = np.round(np.convolve(rng.standard_normal(T + 8), np.ones(8) / 8, "same")[:T] * 3) / 3
    rows.append((q, np.zeros(T), 0.3))
    # saturated: a low threshold admits far more than K candidates
    rows.append((rng.standard_normal(T), rng.standard_normal(T), 0.05))
    # tied heights: one identical triangular peak every 20 samples
    tri = np.tile(np.concatenate([np.arange(10), np.arange(10, 0, -1)]) / 10.0, T // 20 + 1)[:T]
    rows.append((tri, np.zeros(T), 0.5))
    # all zero with a +inf threshold: no candidate, nothing selected
    rows.append((np.zeros(T), np.zeros(T), np.inf))
    # a long plateau in the middle and plateaus touching both edges
    p = 0.1 * np.abs(rng.standard_normal(T))
    p[: 50] = 5.0
    p[-50:] = 5.0
    p[T // 3 : T // 3 + 3000] = 4.0
    rows.append((p, np.zeros(T), 1.0))
    re = np.stack([r[0] for r in rows]).astype(np.float32)
    im = np.stack([r[1] for r in rows]).astype(np.float32)
    thr = np.asarray([r[2] for r in rows], np.float32)
    return re, im, thr


def _host_us(fn, reps: int) -> float:
    """Host time of one call of ``fn`` in microseconds, over ``reps`` calls
    that are not waited for (the launch queue holds them)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


#: host seconds a profiler session waits, the card idle, before the work it
#: times: in a long run the profiler has lost the records of the first
#: kernels of a session (a learned call's first 33 of 53 launches, once;
#: all 20 launches of a 5 ms kernel, once)
PROFILER_SETTLE_S = 0.5


def _profiled(run):
    """``torch.profiler`` over ``run()`` after ``PROFILER_SETTLE_S`` of
    idle time inside the session; returns the profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_SETTLE_S)
        run()
        torch.cuda.synchronize()
    return prof


def _device_ms(fn, reps: int, kernel: str, required: bool = True) -> float | None:
    """Device time of one launch of ``kernel``: its CUPTI records under
    ``torch.profiler`` over ``reps`` calls of ``fn``, after one warm-up.
    Unlike CUDA events around the calls (:func:`_cuda_ms`), it leaves out
    the host's time a call where that is the longer. The mean is over the
    launches the profiler kept: it has dropped records of a long run (17
    of 20 launches of 4.6 ms each, once; all of them, once), so a session
    that kept none is tried twice more; then the phase fails, or, where
    not ``required``, the time is not measured (None)."""
    fn()
    for _ in range(3):
        prof = _profiled(lambda: [fn() for _ in range(reps)])
        us, n = 0.0, 0
        for ev in prof.key_averages():
            if str(getattr(ev, "device_type", "")).endswith("CUDA") and kernel in ev.key:
                t = getattr(ev, "self_device_time_total", None)
                us += t if t is not None else getattr(ev, "self_cuda_time_total", 0.0)
                n += ev.count
        if n > reps or (n and us <= 0):
            fail(f"kernels: the profiler recorded {n} launches of {kernel} ({us} us) in "
                 f"{reps} calls")
        if n:
            return us / n / 1e3
    if required:
        fail(f"kernels: the profiler recorded no launch of {kernel} in three sessions of "
             f"{reps} calls")
    return None


def _spikes(T: int, n: int, rng) -> np.ndarray:
    """A row of zeros with n isolated spikes of random heights in [1, 2):
    exactly n local maxima above a threshold of 0.5."""
    row = np.zeros(T)
    row[np.linspace(1, T - 2, n).round().astype(int)] = 1.0 + rng.random(n)
    return row


def _count_rows(T: int, K: int, rng) -> tuple:
    """(re, im, thr) of two rows, with exactly K and K + 1 candidates."""
    re = np.stack([_spikes(T, K, rng), _spikes(T, K + 1, rng)]).astype(np.float32)
    return re, np.zeros_like(re), np.full(2, 0.5, np.float32)


def _alternating_row(T: int, rng) -> tuple:
    """(re, im, thr) of one row whose every odd sample but the last is a
    local maximum above the threshold: T // 2 - 1 + T % 2 candidates, the
    most a row can hold."""
    re = np.zeros((1, T))
    re[0, 1::2] = 1.0 + rng.random(len(re[0, 1::2]))
    re = re.astype(np.float32)
    return re, np.zeros_like(re), np.full(1, 0.5, np.float32)


def _compare(a, b, where: str = "kernels") -> float:
    """Bitwise equality of the five outputs; returns the max abs error
    over the finite float entries (0.0 when bitwise equal). ``where``
    names the phase in a failure."""
    import torch

    names = ("positions", "heights", "prominences", "selected", "saturated")
    err = 0.0
    for name, x, y in zip(names, a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            fail(f"{where}: {name} shape/dtype {tuple(x.shape)} {x.dtype} != {tuple(y.shape)} {y.dtype}")
        if x.dtype.is_floating_point:
            same = torch.equal(x.isnan(), y.isnan()) and torch.equal(
                torch.nan_to_num(x, nan=0.0), torch.nan_to_num(y, nan=0.0))
            fin = torch.isfinite(x) & torch.isfinite(y)
            if fin.any():
                err = max(err, float((x[fin] - y[fin]).abs().max()))
        else:
            same = torch.equal(x, y)
        if not same:
            bad = int((x != y).sum())
            fail(f"{where}: {name} differs from the plain version in {bad} entries")
    return err


@contextlib.contextmanager
def _capture(mod, name: str, skip=None):
    """Replace ``mod.name`` for the block by a function that forwards every
    call and keeps clones of the arguments of the first call and of the
    latest: yields ``{"n": calls, "first": (args, kw), "last": (args,
    kw)}`` (``"last"`` is the first where there was one call). The inputs
    a main path gives a kernel, held against the plain version after.
    Calls made while ``skip()`` is true are forwarded and not kept."""
    import torch

    orig = getattr(mod, name)
    got = {"n": 0}

    def clone(v):
        return v.clone() if isinstance(v, torch.Tensor) else v

    def spy(*args, **kw):
        if skip is not None and skip():
            return orig(*args, **kw)
        rec = (tuple(clone(a) for a in args), {k: clone(v) for k, v in kw.items()})
        got["first" if got["n"] == 0 else "last"] = rec
        got["n"] += 1
        return orig(*args, **kw)

    setattr(mod, name, spy)
    try:
        yield got
    finally:
        setattr(mod, name, orig)
        if got["n"]:
            got.setdefault("last", got["first"])


def _picks_ctas_want(T: int, K: int, method: str) -> int:
    """CTAs of the pick kernel an SM must hold at rows of ``T`` samples:
    the design's (:data:`PICKS_CTAS_PER_SM`), or as many as an SM's shared
    memory holds where that is fewer (at the 16384-sample bucket the
    envelope alone takes 64 KiB a CTA, so 3 fit)."""
    from das4whales_tpu_torch.ops import fused_picks

    fit = SM_SMEM_BYTES // (fused_picks.smem_bytes(T, K, method) + CTA_RESERVED_SMEM)
    return min(PICKS_CTAS_PER_SM[method], fit)


def _picks_at_main_path(where: str, calls: dict, want_rows: dict) -> tuple:
    """The pick kernel against its plain version on the inputs a main path
    gave it (its first and last launch, from :func:`_capture`): all five
    outputs bitwise, for both methods (``pack`` K=64, ``topk`` K=256);
    and its CTAs an SM at that row length. ``want_rows`` maps ``first`` /
    ``last`` to the rows each launch must have. Returns ``(max_abs_err,
    notes)``."""
    import torch

    from das4whales_tpu_torch.ops import fused_picks

    err, notes = 0.0, []
    for which in ("first", "last"):
        (X, thr, *_), _ = calls[which]
        rows, T = X.shape
        if rows != want_rows[which]:
            fail(f"{where}: the {which} pick launch had {rows} rows, expected {want_rows[which]}")
        for method, K in (("pack", 64), ("topk", 256)):
            k_out = fused_picks.picks_cuda(X, thr, K, method)
            p_out = fused_picks.picks_plain(X, thr, K, method)
            torch.cuda.synchronize()
            err = max(err, _compare(k_out, p_out, where))
            n_sel, n_sat = int(k_out.selected.sum()), int(k_out.saturated.sum())
            if which == "first" and n_sel == 0:
                fail(f"{where}: {method} selected nothing at the first launch; the comparison "
                     "proves nothing")
            notes.append(f"{which} launch {rows}x{T} {method} K={K}: {n_sel} selected, "
                         f"{n_sat} rows saturated")
    T = calls["first"][0][0].shape[-1]
    for method, K in (("pack", 64), ("topk", 256)):
        ctas, want = fused_picks.ctas_per_sm(T, K, method), _picks_ctas_want(T, K, method)
        if ctas < want:
            fail(f"{where}: fused_picks {method} K={K} at T={T} fits {ctas} CTAs an SM, "
                 f"expected {want} ({fused_picks.smem_bytes(T, K, method)} bytes of shared "
                 f"memory a CTA)")
        notes.append(f"{method} K={K} at T={T}: {ctas} CTAs an SM (design "
                     f"{PICKS_CTAS_PER_SM[method]}, shared memory "
                     f"{fused_picks.smem_bytes(T, K, method)} bytes a CTA)")
    return err, notes


#: rows of the STFT kernel's plain version a pass when a route's launch is
#: held against it
STFT_CHECK_ROWS = 8192


def _stft_at_main_path(where: str, calls: dict, want_shape: tuple) -> tuple:
    """The STFT kernel against its plain version on the inputs a main path
    gave it (its first and last launch, from :func:`_capture`), each
    within ``STFT_REL_TOL`` of the plain version's max. Returns
    ``(max_abs_err, relative max error, (nfft, hop))``."""
    import torch

    from das4whales_tpu_torch.ops import fused_stft

    err = rel = 0.0
    for which in ("first", "last"):
        (x, nfft, hop), kw = calls[which]
        if which == "first" and tuple(x.shape) != want_shape:
            fail(f"{where}: the {which} STFT launch took {tuple(x.shape)}, expected {want_shape}")
        k_pow = fused_stft.stft_power_cuda(x, nfft, hop, **kw)
        # the plain version in row blocks: at a slab's 88200 rows its frames
        # and products would take tens of GB at once
        e = scale = 0.0
        for lo in range(0, x.shape[0], STFT_CHECK_ROWS):
            p_pow = fused_stft.stft_power_plain(x[lo : lo + STFT_CHECK_ROWS], nfft, hop, **kw)
            e = max(e, float((k_pow[lo : lo + STFT_CHECK_ROWS] - p_pow).abs().max()))
            scale = max(scale, float(p_pow.abs().max()))
            del p_pow
        torch.cuda.synchronize()
        if not (bool(torch.isfinite(k_pow).all()) and e <= STFT_REL_TOL * scale):
            fail(f"{where}: fused_stft at the {which} launch {tuple(x.shape)} nfft {nfft} hop "
                 f"{hop}: max|kernel - plain| {e:.3e} (limit {STFT_REL_TOL * scale:.3e})")
        err, rel = max(err, e), max(rel, e / scale)
    return err, rel, (calls["first"][0][1], calls["first"][0][2])


def _phase_split(stamps, kernel_ms: float) -> dict:
    """Per-phase figures of one phase-timed launch from its stamps
    ``[rows, 2, phases + 1]`` (``%globaltimer`` ns, ``clock64`` cycles)."""
    from das4whales_tpu_torch.ops import fused_picks

    st = stamps.cpu().numpy().astype(np.float64)
    ns, clk = np.diff(st[:, 0], axis=1), np.diff(st[:, 1], axis=1)
    cta_ns = st[:, 0, -1] - st[:, 0, 0]
    span_ns = st[:, 0, -1].max() - st[:, 0, 0].min()
    return dict(
        phases={name: (float(ns[:, k].mean()), float(ns[:, k].max()), float(clk[:, k].mean()))
                for k, name in enumerate(fused_picks.PHASES)},
        cta_mean_ns=float(cta_ns.mean()), cta_max_ns=float(cta_ns.max()),
        span_ns=float(span_ns), kernel_ms=kernel_ms,
        ghz=float(clk.sum() / ns.sum()),
        # CTAs resident on an SM, averaged over the launch's span
        resident=float(cta_ns.sum() / span_ns / SMS))


def _say_phase_split(label: str, sp: dict) -> None:
    say(f"kernels: fused_picks phase split, {label} (thread 0 of each CTA; mean / max ns "
        f"from %globaltimer, mean cycles from clock64): " + "; ".join(
            f"{name} {m:.0f} / {mx:.0f} ns ({cyc:.0f} cyc)"
            for name, (m, mx, cyc) in sp["phases"].items())
        + f"; CTA {sp['cta_mean_ns']:.0f} mean / {sp['cta_max_ns']:.0f} max ns; first start "
        f"to last end {sp['span_ns'] / 1e3:.2f} us against {sp['kernel_ms'] * 1e3:.2f} us a "
        f"launch of the timed instantiation (profiler, 20 launches); SM clock "
        f"{sp['ghz']:.3f} GHz (cycles / ns); {sp['resident']:.2f} CTAs resident an SM on "
        f"average")


def phase_kernels():
    import torch

    from das4whales_tpu_torch.ops import fused_picks, spectral

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    rows, T = 1024, CANONICAL[1]
    # correlogram-like rows: white noise through the Hilbert transform,
    # thresholds spread so that some rows saturate K=64 and some do not
    corr = torch.as_tensor(rng.standard_normal((rows, T)).astype(np.float32), device=dev)
    X = spectral.analytic_signal(corr)
    thr = torch.as_tensor(np.linspace(2.0, 4.5, rows).astype(np.float32), device=dev)
    out = {}
    err = 0.0
    for method, K in (("pack", 64), ("topk", 256)):
        k_out = fused_picks.picks_cuda(X, thr, K, method)
        p_out = fused_picks.picks_plain(X, thr, K, method)
        torch.cuda.synchronize()
        err = max(err, _compare(k_out, p_out))
        n_sel = int(k_out.selected.sum())
        n_sat = int(k_out.saturated.sum())
        if n_sel == 0:
            fail(f"kernels: {method} selected nothing; the comparison proves nothing")
        ms = _cuda_ms(lambda: fused_picks.picks_cuda(X, thr, K, method), 20)
        device_ms = _device_ms(lambda: fused_picks.picks_cuda(X, thr, K, method), 20,
                               "fused_picks")
        host_us = _host_us(lambda: fused_picks.picks_cuda(X, thr, K, method), 200)
        plain_ms = _cuda_ms(lambda: fused_picks.picks_plain(X, thr, K, method), 3)
        bytes_ = rows * T * 8 + rows * 4 + rows * K * 13 + rows
        bound_ms = max(bytes_ / HBM_BYTES_PER_S, rows * T * 4 / F32_OPS_PER_S) * 1e3
        # the phase-timed instantiation: the same outputs, then its split
        t_out, _ = fused_picks.picks_cuda_timed(X, thr, K, method)
        torch.cuda.synchronize()
        err = max(err, _compare(t_out, p_out))
        timed_ms = _device_ms(lambda: fused_picks.picks_cuda_timed(X, thr, K, method), 20,
                              "fused_picks")
        _, stamps = fused_picks.picks_cuda_timed(X, thr, K, method)
        split = _phase_split(stamps, timed_ms)
        ctas = fused_picks.ctas_per_sm(T, K, method)
        if ctas < PICKS_CTAS_PER_SM[method]:
            fail(f"kernels: fused_picks {method} K={K} fits {ctas} CTAs an SM, its design "
                 f"{PICKS_CTAS_PER_SM[method]}")
        out[method] = dict(K=K, ms=ms, device_ms=device_ms, host_us=host_us, plain_ms=plain_ms,
                           bound_ms=bound_ms,
                           n_sel=n_sel, n_sat=n_sat, timed_ms=timed_ms, split=split, ctas=ctas)
    # the long-row form: rows past one CTA's shared memory, their envelope
    # in a device-memory workspace; an odd length, so odd rows start 8
    # bytes past a 16-byte boundary
    TL = LONG_ROW_SAMPLES + 7
    if fused_picks.fits(TL, 64, "pack", dev) or not fused_picks.fits(T, 256, "topk", dev):
        fail(f"kernels: a row of {TL} samples must need the long-row form and one of {T} not")
    XL = spectral.analytic_signal(torch.as_tensor(
        rng.standard_normal((LONG_ROW_ROWS, TL)).astype(np.float32), device=dev))
    thr_l = torch.as_tensor(np.linspace(2.0, 4.5, LONG_ROW_ROWS).astype(np.float32), device=dev)
    long_row = {}
    for method, K in (("pack", 64), ("topk", 256)):
        fused_picks.long_launches = 0
        k_out = fused_picks.picks_cuda(XL, thr_l, K, method)
        p_out = fused_picks.picks_plain(XL, thr_l, K, method)
        torch.cuda.synchronize()
        err = max(err, _compare(k_out, p_out))
        if fused_picks.long_launches != 1:
            fail(f"kernels: {method}: {LONG_ROW_ROWS}x{TL} took the shared-memory form")
        long_row[method] = dict(
            K=K, ms=_cuda_ms(lambda: fused_picks.picks_cuda(XL, thr_l, K, method), 5),
            plain_ms=_cuda_ms(lambda: fused_picks.picks_plain(XL, thr_l, K, method), 1),
            bound_ms=max((LONG_ROW_ROWS * TL * 8 + LONG_ROW_ROWS * K * 13) / HBM_BYTES_PER_S,
                         LONG_ROW_ROWS * TL * 4 / F32_OPS_PER_S) * 1e3,
            n_sel=int(k_out.selected.sum()))
    del XL
    out["long_row"] = long_row
    # edge rows at T and at a length that is no multiple of nb = 128, and
    # at a long row
    cases = []
    for TT in (T, T - 37, TL):
        cases.append((f"edge rows T={TT}", _edge_rows(TT, rng), (("pack", 64), ("topk", 256))))
    for method, K in (("pack", 64), ("topk", 256)):
        cases.append((f"K and K+1 candidates ({method} K={K})", _count_rows(T, K, rng),
                      ((method, K),)))
    cases.append(("every other sample a maximum", _alternating_row(T, rng),
                  (("pack", 64), ("topk", 256))))
    cases.append((f"every other sample a maximum, T={TL}", _alternating_row(TL, rng),
                  (("pack", 64), ("topk", 256))))
    short = (rng.standard_normal((3, 40)).astype(np.float32),
             rng.standard_normal((3, 40)).astype(np.float32),
             np.asarray([0.5, 1.0, 1.5], np.float32))
    cases.append(("T=40, 3 rows", short, (("pack", 64), ("topk", 256))))
    for label, (re, im, ethr), runs in cases:
        Xe = torch.complex(torch.as_tensor(re, device=dev), torch.as_tensor(im, device=dev))
        te = torch.as_tensor(ethr, device=dev)
        for method, K in runs:
            k_out = fused_picks.picks_cuda(Xe, te, K, method)
            p_out = fused_picks.picks_plain(Xe, te, K, method)
            torch.cuda.synchronize()
            err = max(err, _compare(k_out, p_out))
            if label.startswith("K and K+1"):
                want = [False, True]
                if k_out.saturated.tolist() != want:
                    fail(f"kernels: {label}: saturated {k_out.saturated.tolist()}, want {want}")
    torch.cuda.synchronize()
    pk, tk = out["pack"], out["topk"]
    say(f"kernels: fused_picks == plain, bitwise on all five outputs (max_abs_err {err}); "
        f"a call (CUDA events, 20 in a row) / device time a launch (profiler) / host time a "
        f"call: 1024x{T} pack K=64: {pk['ms']:.4f} / {pk['device_ms']:.4f} ms / "
        f"{pk['host_us']:.1f} us (bound {pk['bound_ms']:.4f} ms, plain {pk['plain_ms']:.3f} "
        f"ms, {pk['n_sel']} selected, {pk['n_sat']} rows saturated, {pk['ctas']} CTAs an "
        f"SM); topk K=256: {tk['ms']:.4f} / {tk['device_ms']:.4f} ms / {tk['host_us']:.1f} us "
        f"(bound {tk['bound_ms']:.4f} ms, plain {tk['plain_ms']:.3f} ms, {tk['n_sel']} "
        f"selected, {tk['ctas']} CTAs an SM); the timed instantiation "
        f"{pk['timed_ms']:.4f} / {tk['timed_ms']:.4f} ms of device time, equal too; the "
        f"long-row form at {LONG_ROW_ROWS}x{TL} (CUDA events, 5 in a row): "
        + ", ".join(f"{m} K={v['K']} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f} ms, plain "
                    f"{v['plain_ms']:.3f} ms, {v['n_sel']} selected)"
                    for m, v in long_row.items())
        + ", equal; cases " + ", ".join(c[0] for c in cases) + " equal")
    for method in ("pack", "topk"):
        _say_phase_split(f"1024x{T} {method} K={out[method]['K']}", out[method]["split"])
    return out, err


def _scene(nx: int, ns: int, n_calls: int, seed: int):
    from das4whales_tpu_torch.io.synth import SyntheticCall, SyntheticScene

    rng = np.random.default_rng(seed)
    span = nx * 2.042
    # alternate the fin HF and LF notes, spread over the record and the cable
    notes = ({"fmin": 17.8, "fmax": 28.8, "duration": 0.68},
             {"fmin": 14.7, "fmax": 21.8, "duration": 0.78})
    calls = [
        SyntheticCall(t0=float(5.0 + k * (ns / 200.0 - 12.0) / max(1, n_calls - 1)),
                      x0_m=float(rng.uniform(0.1, 0.9) * span), amplitude=1.0,
                      **notes[k % 2])
        for k in range(n_calls)
    ]
    return SyntheticScene(nx=nx, ns=ns, noise_rms=0.05, calls=calls, seed=seed)


def _check_calls(scene, picks: dict) -> list:
    """Each injected call must be picked (by any template) on its nearest
    channel within 1 s of its arrival there; returns the misses."""
    from das4whales_tpu_torch.io.synth import call_onsets

    misses = []
    for call in scene.calls:
        ch = int(round(call.x0_m / scene.dx))
        onset = call_onsets(scene, call)[ch]
        hit = any(
            bool(np.any((p[0] == ch) & (np.abs(p[1] - onset) <= scene.fs)))
            for p in picks.values()
        )
        if not hit:
            misses.append((ch, int(onset)))
    return misses


class StageTimer:
    """Records a CUDA event at each stage boundary of one detection run."""

    def __init__(self):
        import torch

        self.torch = torch
        self.marks = []
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record()

    def __call__(self, name: str) -> None:
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev))

    def walls(self) -> dict:
        out, prev = {}, self.start
        for name, ev in self.marks:
            out[name] = out.get(name, 0.0) + prev.elapsed_time(ev)
            prev = ev
        return out


def phase_detect(while_waiting=None):
    """``while_waiting(scene, raw, design)``, when given, runs once the
    block and its design are ready, before the phase waits for the early
    host jobs (the card is idle there: the run's ``analysis`` phase)."""
    import torch

    from das4whales_tpu_torch.io.synth import synthesize_scene, to_raw_counts
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.ops import fused_picks

    nx, ns = CANONICAL
    t0 = time.perf_counter()
    scene = _scene(nx, ns, n_calls=6, seed=SEED)
    raw = to_raw_counts(synthesize_scene(scene), scene.metadata)
    t_scene = time.perf_counter() - t0
    # the detector's own design (design_matched_filter at the constructor's
    # defaults), made by a host job started before the build
    t0 = time.perf_counter()
    t_host, design = _early("canonical_design", lambda: _design_job((nx, ns), scene.metadata)[1])
    det = MatchedFilterDetector.from_design(design, scene.metadata, templates="fin", wire="raw")
    t_design = time.perf_counter() - t0
    if det._route() != "tiled":
        fail(f"detect: the auto route resolved to {det._route()!r}, expected 'tiled'")
    n_tiles = -(-nx // det.effective_channel_tile)
    t0 = time.perf_counter()
    x = torch.as_tensor(raw).to("cuda")
    torch.cuda.synchronize()
    t_h2d = time.perf_counter() - t0
    if while_waiting is not None:
        while_waiting(scene, raw, design)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t_wait = _await_early()

    det.detect_picks(x)                      # warm-up: cuFFT plans, kernel load
    torch.cuda.synchronize()
    zero_launches()                          # the main path's runs start here
    det.syncs = det.dispatches = det.escalations = 0
    walls, stages, per_run = [], [], []
    res = None
    for _ in range(3):
        before = (fused_picks.launches, det.syncs, det.dispatches)
        timer = StageTimer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = det.detect_picks(x, stage_hook=timer)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        stages.append(timer.walls())
        per_run.append((fused_picks.launches - before[0], det.syncs - before[1],
                        det.dispatches - before[2]))
    launches = read_launches()
    for k, (n_launch, n_sync, n_disp) in enumerate(per_run):
        if n_launch < n_tiles * n_disp:
            fail(f"detect: run {k} launched the pick kernel {n_launch} times in "
                 f"{n_disp} attempts, expected >= {n_tiles} each")
        # one packed fetch per attempt (+1 full transfer on capacity overflow)
        if n_sync not in (n_disp, n_disp + 1):
            fail(f"detect: run {k} made {n_sync} device->host copies for {n_disp} attempts")
    for name, p in res.picks.items():
        if p.ndim != 2 or p.shape[0] != 2:
            fail(f"detect: template {name} returned picks of shape {p.shape}")
        if not (np.all((p[0] >= 0) & (p[0] < nx)) and np.all((p[1] >= 0) & (p[1] < ns))):
            fail(f"detect: template {name} has picks outside the block")
    for name, t in res.thresholds.items():
        if not np.isfinite(t) or t <= 0:
            fail(f"detect: template {name} threshold {t}")
    misses = _check_calls(scene, res.picks)
    if misses:
        fail(f"detect: injected calls not picked on their nearest channel within 1 s: {misses}")
    med = {k: statistics.median(s[k] for s in stages) for k in stages[0]}
    say(f"detect: {nx}x{ns} raw int32, fin bank, route tiled ({n_tiles} tiles of "
        f"{det.effective_channel_tile}); median wall {statistics.median(walls) * 1e3:.1f} ms "
        f"(runs {', '.join(f'{w * 1e3:.1f}' for w in walls)} ms); stage walls (median, "
        f"CUDA events) {json.dumps({k: round(v, 3) for k, v in med.items()})} ms; "
        f"picks {json.dumps({k: int(v.shape[1]) for k, v in res.picks.items()})}; "
        f"thresholds {json.dumps({k: round(v, 6) for k, v in res.thresholds.items()})}; "
        f"escalations {det.escalations} in 3 runs; per run (kernel launches, syncs, "
        f"attempts) {[r for r in per_run]}; all {len(scene.calls)} injected calls picked; "
        f"set-up: scene {t_scene:.1f} s, design {t_host:.1f} s on the host (waited for "
        f"{t_design:.1f} s), H2D {t_h2d * 1e3:.1f} ms, "
        f"the early host jobs awaited {t_wait:.1f} s"
        + (f" (after the analysis phase, {_PHASE_SECONDS['analysis']:.1f} s, ran in the wait)"
           if while_waiting is not None and "analysis" in _PHASE_SECONDS else "") + "; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _profile("detect_picks", lambda: det.detect_picks(x), statistics.median(walls),
             "fused_picks")
    return launches["fused_picks"], scene, raw, det.design


def _profile(label: str, run, wall_s: float, kernel: str) -> dict:
    """One more run under ``torch.profiler`` (outside the counted runs):
    device time by kernel family (``kernel``, cuFFT, other), and the
    device's busy share of the unprofiled median wall. A profiler that
    fails or records no device time fails the phase."""
    prof = _profiled(run)
    fams = {kernel: 0.0, "cuFFT": 0.0, "other": 0.0}
    per_kernel = []
    n_kernels = 0
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA") and ev.key and not ev.key.startswith("cuda"):
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0.0)
            if us <= 0:
                continue
            n_kernels += ev.count
            name = ev.key.lower()
            fam = (kernel if kernel in name
                   else "cuFFT" if "fft" in name else "other")
            fams[fam] += us / 1e3
            per_kernel.append((us / 1e3, ev.count, ev.key[:70]))
    busy = sum(fams.values())
    top = sorted(per_kernel, reverse=True)[:8]
    if busy == 0.0:
        fail(f"profile: the profiler recorded no device time for {label}")
    say(f"profile: one {label} under torch.profiler: device time by kernel family "
        f"{json.dumps({k: round(v, 3) for k, v in fams.items()})} ms over {n_kernels} "
        f"kernel launches; busy {busy:.3f} ms = {100 * busy / (wall_s * 1e3):.1f} % of the "
        f"unprofiled median wall {wall_s * 1e3:.1f} ms (idle share "
        f"{100 * max(0.0, 1 - busy / (wall_s * 1e3)):.1f} %); top kernels (ms, launches): "
        + "; ".join(f"{ms:.3f} x{n} {name}" for ms, n, name in top))
    return fams


def phase_cpu_vs_card():
    """The port on the card against the port on the CPU, twice: at the
    defaults, and with K0 = 1 and a 256-pick capacity, which forces the
    K0 -> K = 256 ``topk`` escalation and the capacity-overflow route."""
    from das4whales_tpu_torch.io.synth import synthesize_scene, to_raw_counts
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.utils.parity import envelopes, unexplained_differences

    nx, ns = 512, CANONICAL[1]
    scene = _scene(nx, ns, n_calls=1, seed=SEED + 1)
    raw = to_raw_counts(synthesize_scene(scene), scene.metadata)
    notes = []
    for label, k0, cap in (("defaults", None, 1 << 18), ("K0=1, capacity 256", 1, 256)):
        res, dets = {}, {}
        for dev in ("cuda", "cpu"):
            det = MatchedFilterDetector(scene.metadata, [0, nx, 1], (nx, ns), wire="raw",
                                        pick_pack_cap=cap, device=dev)
            if k0 is not None:
                det.pick_k0 = k0
            res[dev], dets[dev] = det.detect_picks(raw), det
        if k0 is not None and (dets["cuda"].escalations != 1
                               or dets["cuda"].syncs != dets["cuda"].dispatches + 1):
            fail(f"cpu_vs_card: {label}: expected one escalation and one overflow "
                 f"transfer, got {dets['cuda'].escalations} escalations, "
                 f"{dets['cuda'].syncs} syncs for {dets['cuda'].dispatches} attempts")
        env = envelopes(dets["cpu"], raw)
        n_diff = 0
        for i, name in enumerate(res["cpu"].picks):
            tg, tc = res["cuda"].thresholds[name], res["cpu"].thresholds[name]
            if not np.isclose(tg, tc, rtol=1e-5, atol=0):
                fail(f"cpu_vs_card: {label}: template {name} threshold card {tg} vs cpu {tc}")
            a, b = res["cuda"].picks[name], res["cpu"].picks[name]
            bad = unexplained_differences(a, b, env[i], tc)
            if bad:
                fail(f"cpu_vs_card: {label}: template {name}: picks differ beyond "
                     f"rounding at {bad[:10]}")
            n_diff += len({tuple(p) for p in a.T.tolist()} ^ {tuple(p) for p in b.T.tolist()})
        if _check_calls(scene, res["cuda"].picks):
            fail(f"cpu_vs_card: {label}: the injected call was not picked on the card")
        notes.append(f"{label}: picks "
                     f"{json.dumps({k: int(v.shape[1]) for k, v in res['cuda'].picks.items()})}"
                     f" on the card, {n_diff} differing")
    say(f"cpu_vs_card: {nx}x{ns}, thresholds within rtol 1e-5, differing picks all on "
        f"rounding knife edges; {'; '.join(notes)}")

@functools.lru_cache(maxsize=1)
def _canonical_block():
    """``(scene, raw)``: the ``detect`` phase's canonical block, for the
    phases that run without ``detect`` before them (``--only``)."""
    from das4whales_tpu_torch.io.synth import synthesize_scene, to_raw_counts

    nx, ns = CANONICAL
    scene = _scene(nx, ns, n_calls=6, seed=SEED)
    return scene, to_raw_counts(synthesize_scene(scene), scene.metadata)


def _canonical_inputs():
    """``(scene, raw, design)``: the canonical block and its fin design
    (the design is about half a minute of host work)."""
    from das4whales_tpu_torch.models.matched_filter import design_matched_filter

    nx, ns = CANONICAL
    scene, raw = _canonical_block()
    return scene, raw, design_matched_filter((nx, ns), [0, nx, 1], scene.metadata,
                                             templates="fin")


def _timed_runs(call, counters, n: int = 3):
    """``n`` runs of ``call(stage_hook)`` after the caller's warm-up: each
    run's wall (host clock around a synchronised call), its stage walls
    (CUDA events) and the change of each counter (``{name: getter}``)
    over it. Returns ``(walls, stages, deltas, last result)``."""
    import torch

    walls, stages, deltas, res = [], [], [], None
    for _ in range(n):
        before = {k: get() for k, get in counters.items()}
        res = None                           # the previous run's result is freed first
        timer = StageTimer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = call(timer)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        stages.append(timer.walls())
        deltas.append({k: get() - before[k] for k, get in counters.items()})
    return walls, stages, deltas, res


def _median_stages(stages: list) -> dict:
    return {k: round(statistics.median(s[k] for s in stages), 3) for k in stages[0]}


def phase_full(scene=None, raw=None, design=None):
    """``MatchedFilterDetector(...)(trace, with_snr=True)`` — the flagship
    ``main_mfdetect.py``'s full-artifact call, at the workflow's settings
    (``pick_mode`` auto -> sparse on the card, ``keep_correlograms``) — on
    the canonical block, on ``detect``'s design; then ``pick_mode="dense"``
    against the sparse route at 512 x 12000."""
    import warnings

    import torch

    from das4whales_tpu_torch.io.synth import synthesize_scene, to_raw_counts
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.ops import fused_picks
    from das4whales_tpu_torch.ops.peaks import convert_pick_times

    if design is None:
        scene, raw, design = _canonical_inputs()
    nx, ns = raw.shape
    det = MatchedFilterDetector.from_design(design, scene.metadata, wire="raw")
    if (det.pick_mode, det.keep_correlograms, det._route()) != ("sparse", True, "tiled"):
        fail(f"full: the detector resolved pick_mode {det.pick_mode!r}, keep_correlograms "
             f"{det.keep_correlograms}, route {det._route()!r}; expected sparse, True, tiled")
    tile = det.effective_channel_tile
    n_tiles = -(-nx // tile)
    nT = len(det.design.template_names)
    x = torch.as_tensor(raw).to("cuda")
    det(x, with_snr=True)                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()                          # the main path's runs start here
    det.syncs = det.escalations = 0
    walls, stages, deltas, res = _timed_runs(
        lambda hook: det(x, with_snr=True, stage_hook=hook),
        {"launches": lambda: fused_picks.launches, "syncs": lambda: det.syncs,
         "escalations": lambda: det.escalations})
    launches = read_launches()["fused_picks"]
    peak = torch.cuda.max_memory_allocated()
    for k, d in enumerate(deltas):
        if d["launches"] != n_tiles * (1 + d["escalations"]):
            fail(f"full: run {k} launched the pick kernel {d['launches']} times with "
                 f"{d['escalations']} escalations, expected {n_tiles} an attempt")
    ref = det.detect_picks(x)                # the one-program route, same detector
    for name in ref.picks:
        if not np.array_equal(res.picks[name], ref.picks[name]):
            fail(f"full: template {name}: __call__'s picks differ from detect_picks'")
        if res.thresholds[name] != ref.thresholds[name]:
            fail(f"full: template {name}: threshold {res.thresholds[name]} != detect_picks' "
                 f"{ref.thresholds[name]}")
    misses = _check_calls(scene, res.picks)
    if misses:
        fail(f"full: injected calls not picked on their nearest channel within 1 s: {misses}")
    if not torch.equal(res.trf_fk, det.filter_block(x)):
        fail("full: trf_fk differs from filter_block(trace)")
    n_neginf = 0
    for name in det.design.template_names:
        c, s = res.correlograms[name], res.snr[name]
        if tuple(c.shape) != (nx, ns) or not bool(torch.isfinite(c).all()):
            fail(f"full: template {name}: correlograms {tuple(c.shape)} not all finite")
        # 10 log10(|a|^2 / std^2): -inf only where the envelope is exactly 0
        if tuple(s.shape) != (nx, ns) or bool(torch.isnan(s).any() | torch.isposinf(s).any()):
            fail(f"full: template {name}: SNR {tuple(s.shape)} has NaN or +inf")
        n_neginf += int(torch.isneginf(s).sum())
    wall = statistics.median(walls)
    fams = _profile("__call__(with_snr=True)", lambda: det(x, with_snr=True), wall, "fused_picks")
    del res, ref
    with _capture(fused_picks, "picks_cuda") as calls:
        det(x, with_snr=True)
        torch.cuda.synchronize()
    err, notes = _picks_at_main_path("full", calls, {"first": nT * tile,
                                                     "last": nT * (nx - (n_tiles - 1) * tile)})
    del calls, x, det
    torch.cuda.empty_cache()
    say(f"full: {nx}x{ns} raw int32, fin bank, MatchedFilterDetector(...)(trace, "
        f"with_snr=True) at mfdetect.main's settings (pick_mode sparse, keep_correlograms), "
        f"route tiled ({n_tiles} tiles of {tile}); median wall {wall * 1e3:.1f} ms (runs "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms); stage walls (median, CUDA events) "
        f"{json.dumps(_median_stages(stages))} ms; per run (kernel launches, syncs, "
        f"escalations) {[tuple(d.values()) for d in deltas]}; peak device memory "
        f"{peak / 2**30:.2f} GiB; picks and thresholds bitwise detect_picks' on the same "
        f"detector, trf_fk bitwise filter_block's, correlograms finite, SNR without NaN or "
        f"+inf ({n_neginf} samples at -inf); all {len(scene.calls)} injected calls picked; "
        f"fused_picks bitwise its plain version at the route's first and last launch: "
        f"{'; '.join(notes)}")

    # pick_mode="dense" against the sparse route, on the card, at 512 x 12000
    nx2 = 512
    scene2 = _scene(nx2, ns, n_calls=1, seed=SEED + 1)
    raw2 = to_raw_counts(synthesize_scene(scene2), scene2.metadata)
    sparse = MatchedFilterDetector(scene2.metadata, [0, nx2, 1], (nx2, ns), wire="raw")
    dense = MatchedFilterDetector.from_design(sparse.design, scene2.metadata, wire="raw",
                                              pick_mode="dense")
    x2 = torch.as_tensor(raw2).to("cuda")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rs = sparse(x2)
        dense(x2)                            # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rd = dense(x2)
        t_dense = time.perf_counter() - t0
    if any("saturated" in str(w.message) for w in caught):
        fail("full: dense vs sparse: a sparse row saturated; the comparison needs none")
    n_picks = 0
    for name in rs.picks:
        mask = np.zeros((nx2, ns), bool)
        mask[rs.picks[name][0], rs.picks[name][1]] = True
        if not (np.array_equal(rd.picks[name], rs.picks[name])
                and np.array_equal(rd.peak_masks[name], mask)
                and np.array_equal(convert_pick_times(rd.peak_masks[name]), rd.picks[name])
                and rd.thresholds[name] == rs.thresholds[name]):
            fail(f"full: template {name}: the dense route's picks or peak mask differ from "
                 "the sparse route's")
        n_picks += rs.picks[name].shape[1]
    if n_picks == 0 or _check_calls(scene2, rd.picks):
        fail("full: dense: no picks, or the injected call was missed")
    say(f"full: pick_mode dense at {nx2}x{ns} on the card (route {dense._route()}, peak_block "
        f"{dense.peak_block}): picks and peak masks equal the sparse route's ({n_picks} "
        f"picks, no row saturated), thresholds equal; dense call {t_dense * 1e3:.1f} ms")
    return launches, err, {"wall_ms": wall * 1e3, "stages": _median_stages(stages),
                           "peak_gib": peak / 2**30, "fams": fams}


def phase_full_cpu_vs_card():
    """``__call__(trace, with_snr=True)`` on the card against
    ``device="cpu"`` at 512 x 12000, each at its defaults (sparse on the
    card, scipy on the CPU)."""
    from das4whales_tpu_torch.io.synth import synthesize_scene, to_raw_counts
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.ops import spectral
    from das4whales_tpu_torch.utils.parity import unexplained_differences

    nx, ns = 512, CANONICAL[1]
    scene = _scene(nx, ns, n_calls=1, seed=SEED + 1)
    raw = to_raw_counts(synthesize_scene(scene), scene.metadata)
    card = MatchedFilterDetector(scene.metadata, [0, nx, 1], (nx, ns), wire="raw")
    cpu = MatchedFilterDetector.from_design(card.design, scene.metadata, wire="raw",
                                            device="cpu")
    rc, rp = card(raw, with_snr=True), cpu(raw, with_snr=True)
    worst = {"trf_fk": 0.0, "correlograms": 0.0, "snr_db": 0.0}

    def rel(a, b):
        return float((a.cpu() - b).abs().max()) / float(b.abs().max())

    worst["trf_fk"] = rel(rc.trf_fk, rp.trf_fk)
    n_diff = 0
    for name in rp.picks:
        tg, tc = rc.thresholds[name], rp.thresholds[name]
        if not np.isclose(tg, tc, rtol=1e-5, atol=0):
            fail(f"full_cpu_vs_card: template {name} threshold card {tg} vs cpu {tc}")
        worst["correlograms"] = max(worst["correlograms"],
                                    rel(rc.correlograms[name], rp.correlograms[name]))
        s, sp_ = rc.snr[name].cpu().numpy(), rp.snr[name].numpy()
        near = sp_ > sp_.max() - 60.0
        if not np.isfinite(s[near]).all():
            fail(f"full_cpu_vs_card: template {name}: card SNR not finite where the CPU's is")
        worst["snr_db"] = max(worst["snr_db"], float(np.abs(s - sp_)[near].max()))
        env = spectral.envelope_sqrt(rp.correlograms[name]).numpy()
        a, b = rc.picks[name], rp.picks[name]
        bad = unexplained_differences(a, b, env, tc)
        if bad:
            fail(f"full_cpu_vs_card: template {name}: picks differ beyond rounding at "
                 f"{bad[:10]}")
        n_diff += len({tuple(p) for p in a.T.tolist()} ^ {tuple(p) for p in b.T.tolist()})
    if worst["trf_fk"] > 1e-4 or worst["correlograms"] > 1e-4 or worst["snr_db"] > 0.01:
        fail(f"full_cpu_vs_card: beyond tolerance (trf_fk and correlograms 1e-4 * max, SNR "
             f"0.01 dB within 60 dB of its max): {worst}")
    if _check_calls(scene, rc.picks):
        fail("full_cpu_vs_card: the injected call was not picked on the card")
    say(f"full_cpu_vs_card: {nx}x{ns}, __call__(with_snr=True), card ({card.pick_mode}, route "
        f"{card._route()}) against CPU ({cpu.pick_mode}): thresholds within rtol 1e-5; "
        f"relative max error trf_fk {worst['trf_fk']:.2e}, correlograms "
        f"{worst['correlograms']:.2e} (limit 1e-4); SNR max |card - cpu| "
        f"{worst['snr_db']:.2e} dB within 60 dB of its max (limit 0.01 dB); picks "
        f"{json.dumps({k: int(v.shape[1]) for k, v in rc.picks.items()})} on the card, "
        f"{n_diff} differing, all on rounding knife edges")


def phase_channel_pad(scene=None, raw=None, design=None):
    """The canonical block on a design padded to 22500 channels
    (``channel_pad="auto"``): the f-k stage padded against unpadded, in
    turns, the padded ``detect_picks`` wall and its recall."""
    import torch

    from das4whales_tpu_torch.models.matched_filter import (MatchedFilterDetector,
                                                            design_matched_filter)
    from das4whales_tpu_torch.ops import fused_picks
    from das4whales_tpu_torch.ops.xcorr import next_fast_len

    if design is None:
        scene, raw, design = _canonical_inputs()
    nx, ns = raw.shape
    t_design, pdesign = _early("channel_pad", lambda: design_matched_filter(
        (nx, ns), [0, nx, 1], scene.metadata, templates="fin", channel_pad="auto"))
    want = next_fast_len(nx)                 # 22050 -> 22500
    if pdesign.fk_channels != want or pdesign.fk_mask.shape != (want, ns):
        fail(f"channel_pad: 'auto' gave {pdesign.fk_channels} channels, expected {want}")
    dets = {"unpadded": MatchedFilterDetector.from_design(design, scene.metadata, wire="raw"),
            "padded": MatchedFilterDetector.from_design(pdesign, scene.metadata, wire="raw")}
    x = torch.as_tensor(raw).to("cuda")
    for d in dets.values():
        d.detect_picks(x)                    # warm-up: each shape's cuFFT plans
    torch.cuda.synchronize()
    fk_ms = {k: [] for k in dets}
    for label in ("unpadded", "padded", "padded", "unpadded"):   # in turns
        fk_ms[label].append(_cuda_ms(lambda d=dets[label]: d.filter_block(x), 10))
    zero_launches()
    out = {}
    for label in ("unpadded", "padded"):
        d = dets[label]
        walls, stages, deltas, res = _timed_runs(
            lambda hook, d=d: d.detect_picks(x, stage_hook=hook),
            {"launches": lambda: fused_picks.launches, "attempts": lambda d=d: d.dispatches})
        hit = len(scene.calls) - len(_check_calls(scene, res.picks))
        out[label] = dict(wall=statistics.median(walls), stages=_median_stages(stages),
                          deltas=[tuple(v.values()) for v in deltas], recall=hit,
                          picks={k: int(v.shape[1]) for k, v in res.picks.items()})
    if out["padded"]["recall"] != len(scene.calls):
        fail(f"channel_pad: the padded design picked {out['padded']['recall']} of "
             f"{len(scene.calls)} injected calls")
    del dets, x
    torch.cuda.empty_cache()
    p, u = out["padded"], out["unpadded"]
    say(f"channel_pad: {nx}x{ns} raw int32 on a design padded to {pdesign.fk_channels} "
        f"channels (host design {t_design:.1f} s): filter_block (condition + f-k) by CUDA "
        f"events, 10 calls, in turns unpadded/padded/padded/unpadded: unpadded "
        f"{', '.join(f'{v:.3f}' for v in fk_ms['unpadded'])} ms, padded "
        f"{', '.join(f'{v:.3f}' for v in fk_ms['padded'])} ms; detect_picks median wall "
        f"padded {p['wall'] * 1e3:.1f} ms, unpadded {u['wall'] * 1e3:.1f} ms; stage walls "
        f"(median, CUDA events) padded {json.dumps(p['stages'])}, unpadded "
        f"{json.dumps(u['stages'])} ms; per run (launches, attempts) padded {p['deltas']}; "
        f"recall padded {p['recall']}/{len(scene.calls)}, unpadded "
        f"{u['recall']}/{len(scene.calls)}; picks padded {json.dumps(p['picks'])}, unpadded "
        f"{json.dumps(u['picks'])} (not compared: the pad moves the wrap edge)")
    return {"fk_ms": fk_ms, "padded": p, "unpadded": u}


def phase_bank(scene=None, raw=None, design=None):
    """The canonical block through ``detect_picks`` with the
    ``fin-variants`` bank (4 templates, per-template thresholds), on
    ``detect``'s f-k design with the bank's stack compiled in; then the
    bank's ``split_views`` halves against the full bank's rows, bit for
    bit, on the card."""
    import dataclasses

    import torch

    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.models.templates import resolve_bank
    from das4whales_tpu_torch.ops import fused_picks

    if design is None:
        scene, raw, design = _canonical_inputs()
    nx, ns = raw.shape
    bank = resolve_bank("fin-variants")
    # what design_matched_filter(templates=bank) makes: the same mask and
    # gain, the bank's stack and threshold policy
    bdesign = dataclasses.replace(
        design, templates=bank.compile(ns, scene.metadata.fs), template_names=bank.names,
        threshold_factors=bank.threshold_factors(), threshold_scope=bank.threshold_scope)
    det = MatchedFilterDetector.from_design(bdesign, scene.metadata, templates=bank, wire="raw")
    if not det.supports_bank_split or det._route() != "tiled":
        fail("bank: the fin-variants detector is not splittable or not tiled")
    tile = det.effective_channel_tile
    n_tiles = -(-nx // tile)
    nT = len(bank)
    x = torch.as_tensor(raw).to("cuda")
    det.detect_picks(x)                      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()                          # the main path's runs start here
    walls, stages, deltas, res = _timed_runs(
        lambda hook: det.detect_picks(x, stage_hook=hook),
        {"launches": lambda: fused_picks.launches, "attempts": lambda: det.dispatches,
         "syncs": lambda: det.syncs})
    launches = read_launches()["fused_picks"]
    peak = torch.cuda.max_memory_allocated()
    for k, d in enumerate(deltas):
        if d["launches"] != n_tiles * d["attempts"]:
            fail(f"bank: run {k} launched the pick kernel {d['launches']} times in "
                 f"{d['attempts']} attempts, expected {n_tiles} each")
    misses = _check_calls(scene, res.picks)
    if misses:
        fail(f"bank: injected calls not picked on their nearest channel within 1 s: {misses}")
    halves, split_ms = det.split_views(), []
    n_same = 0
    for h in halves:
        h.detect_picks(x)                    # warm-up of the half's shapes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hr = h.detect_picks(x)
        split_ms.append((time.perf_counter() - t0) * 1e3)
        for name in hr.picks:
            if not np.array_equal(hr.picks[name], res.picks[name]):
                a = {tuple(p) for p in hr.picks[name].T.tolist()}
                b = {tuple(p) for p in res.picks[name].T.tolist()}
                fail(f"bank: split_views half {h.design.template_names}: template {name}'s "
                     f"picks differ from the full bank's row ({len(a ^ b)} of {len(b)} picks)")
            if hr.thresholds[name] != res.thresholds[name]:
                fail(f"bank: split_views half: template {name} threshold "
                     f"{hr.thresholds[name]} != the full bank's {res.thresholds[name]}")
            n_same += int(hr.picks[name].shape[1])
    with _capture(fused_picks, "picks_cuda") as calls:
        det.detect_picks(x)
        torch.cuda.synchronize()
    err, notes = _picks_at_main_path("bank", calls, {"first": nT * tile,
                                                     "last": nT * (nx - (n_tiles - 1) * tile)})
    wall = statistics.median(walls)
    del calls, x, det, halves
    torch.cuda.empty_cache()
    say(f"bank: {nx}x{ns} raw int32, bank fin-variants ({nT} templates, "
        f"{bank.threshold_scope} scope), detect_picks, route tiled ({n_tiles} tiles of "
        f"{tile}, {nT * tile} rows a pick launch); median wall {wall * 1e3:.1f} ms (runs "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms); stage walls (median, CUDA events) "
        f"{json.dumps(_median_stages(stages))} ms; per run (launches, attempts, syncs) "
        f"{[tuple(d.values()) for d in deltas]}; picks "
        f"{json.dumps({k: int(v.shape[1]) for k, v in res.picks.items()})}; all "
        f"{len(scene.calls)} injected calls picked; peak device memory {peak / 2**30:.2f} GiB; "
        f"split_views halves (2 + 2 templates, {split_ms[0]:.1f} and {split_ms[1]:.1f} ms): "
        f"picks and thresholds bitwise the full bank's rows ({n_same} picks); fused_picks "
        f"bitwise its plain version at the route's first and last launch: {'; '.join(notes)}")
    return launches, err, {"wall_ms": wall * 1e3, "stages": _median_stages(stages),
                           "peak_gib": peak / 2**30, "split_ms": split_ms}


#: STFT of the spectro family at its defaults: 0.8 s window at 200 Hz,
#: 95 % overlap
NFFT, HOP = 160, 8
STFT_REL_TOL = 5e-6


def _stft_bounds(C: int, T: int, nfft: int, hop: int, center: bool = True) -> dict:
    """The least time the card could take for one launch: the input read
    once and the power written once over HBM, and the operations the
    function needs over the float32 rate of the CUDA cores — per frame
    the window (nfft), a real FFT (2.5 nfft log2 nfft, half the usual
    5 N log2 N of a complex one) and the power (3 per bin). ``dft_*`` is
    the earlier design's dense DFT contraction (2 operations per
    multiply-add, re and im) and ``fold_*`` the kernel's folded DFT (per
    frame (re, im) multiply-adds over taps n <= N/2 and k <= N/4 — every
    k < F for odd N — the folds u, v, the E/O pairing and the power):
    side figures, not the bound."""
    F = nfft // 2 + 1
    nf = 1 + (T // hop if center else (T - nfft) // hop)
    bytes_ = 4 * C * T + 4 * nfft * 2 * F + 4 * C * F * nf
    ops = C * nf * (nfft + 2.5 * nfft * float(np.log2(nfft)) + 3 * F)
    dft_ops = 2 * C * nf * nfft * 2 * F
    even = nfft % 2 == 0
    taps, K2 = nfft // 2 + 1, nfft // 4 + 1 if even else F
    fold_ops = C * nf * (4 * taps * K2 + 2 * (taps - 1) + (4 if even else 2) * K2 + 3 * F)
    b_ms, o_ms = bytes_ / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return {"bytes": bytes_, "ops": ops, "bytes_ms": b_ms, "ops_ms": o_ms,
            "dft_ops": dft_ops, "dft_ops_ms": dft_ops / F32_OPS_PER_S * 1e3,
            "fold_ops": fold_ops, "fold_ops_ms": fold_ops / F32_OPS_PER_S * 1e3,
            "bound_ms": max(b_ms, o_ms), "bound_by": "operations" if o_ms >= b_ms else "bytes"}


def _torch_stft_power(x, nfft: int, hop: int, window: str = "hann", center: bool = True):
    """The library yardstick: ``torch.stft`` (zero padding, as the port
    centres) and its power. Timed here only; the port never calls it."""
    import torch

    win = (torch.hann_window(nfft, periodic=True, device=x.device) if window == "hann"
           else torch.ones(nfft, device=x.device))
    s = torch.stft(x, nfft, hop, window=win, center=center, pad_mode="constant",
                   return_complex=True)
    return s.real * s.real + s.imag * s.imag


def phase_stft_kernel():
    import torch

    from das4whales_tpu_torch.ops import fused_stft

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 2)
    cases = [  # (label, C, T, nfft, hop, center, window)
        ("main 4096x12000", 4096, CANONICAL[1], NFFT, HOP, True, "hann"),
        ("ragged 1570 channels", 1570, CANONICAL[1], NFFT, HOP, True, "hann"),
        ("T=11963", 256, 11963, NFFT, HOP, True, "hann"),
        ("center=False", 256, CANONICAL[1], NFFT, HOP, False, "hann"),
        ('window="ones"', 256, CANONICAL[1], NFFT, HOP, True, "ones"),
        ("hop=nfft", 256, CANONICAL[1], NFFT, NFFT, True, "hann"),
        ("T<nfft", 3, 100, NFFT, HOP, True, "hann"),
        # spans past 48 KB of shared memory: the fold straight from x
        ("nfft=1024 hop=384", 64, CANONICAL[1], 1024, 384, True, "hann"),
        ("nfft=hop=2048", 64, CANONICAL[1], 2048, 2048, True, "hann"),
        # odd nfft (the first fold only), and nfft = 2 mod 4 (no self-paired bin)
        ("nfft=65", 256, CANONICAL[1], 65, HOP, True, "hann"),
        ("nfft=162", 256, CANONICAL[1], 162, HOP, True, "hann"),
    ]
    err, notes, main = 0.0, [], None
    for label, C, T, nfft, hop, center, window in cases:
        x = torch.as_tensor(rng.standard_normal((C, T)).astype(np.float32), device=dev)
        kw = dict(window=window, center=center)
        k = fused_stft.stft_power_cuda(x, nfft, hop, **kw)
        p = fused_stft.stft_power_plain(x, nfft, hop, **kw)
        lib = _torch_stft_power(x, nfft, hop, window, center)
        torch.cuda.synchronize()
        # centred odd nfft: torch.stft pads nfft // 2 a side and frames
        # 1 + (T - 1) // hop, one less than the port's 1 + T // hop where hop
        # divides T (that last frame reads zeros past the padding); it is
        # compared on the frames it has
        k_lib = k[..., :lib.shape[-1]] if nfft % 2 and center else k
        if k.shape != p.shape or k_lib.shape != lib.shape:
            fail(f"stft_kernel: {label}: shapes kernel {tuple(k.shape)}, plain "
                 f"{tuple(p.shape)}, torch.stft {tuple(lib.shape)}")
        if not bool(torch.isfinite(k).all()):
            fail(f"stft_kernel: {label}: non-finite kernel output")
        e_plain = float((k - p).abs().max())
        e_lib = float((k_lib - lib).abs().max())
        s_plain, s_lib = float(p.abs().max()), float(lib.abs().max())
        if e_plain > STFT_REL_TOL * s_plain or e_lib > STFT_REL_TOL * s_lib:
            fail(f"stft_kernel: {label}: max|kernel - plain| {e_plain:.3e} (limit "
                 f"{STFT_REL_TOL * s_plain:.3e}), max|kernel - torch.stft| {e_lib:.3e} "
                 f"(limit {STFT_REL_TOL * s_lib:.3e})")
        err = max(err, e_plain)
        notes.append(f"{label}: {e_plain / s_plain:.2e} / {e_lib / s_lib:.2e}")
        if main is None:
            main = dict(
                ms=_cuda_ms(lambda: fused_stft.stft_power_cuda(x, nfft, hop, **kw), 20),
                device_ms=_device_ms(lambda: fused_stft.stft_power_cuda(x, nfft, hop, **kw),
                                     20, "fused_stft"),
                plain_ms=_cuda_ms(lambda: fused_stft.stft_power_plain(x, nfft, hop, **kw), 5),
                library_ms=_cuda_ms(lambda: _torch_stft_power(x, nfft, hop, window, center), 10),
                **_stft_bounds(C, T, nfft, hop, center))
        del x, k, k_lib, p, lib
    m = main
    say(f"stft_kernel: fused_stft within {STFT_REL_TOL} * max of its plain version and of "
        f"torch.stft power on all {len(cases)} cases (relative max error plain / torch.stft: "
        f"{'; '.join(notes)}); max_abs_err vs plain {err:.3e}; 4096x12000 nfft {NFFT} hop {HOP}: "
        f"kernel {m['ms']:.4f} ms a call (device time {m['device_ms']:.4f} ms), plain {m['plain_ms']:.3f} ms, torch.stft + power "
        f"{m['library_ms']:.3f} ms; bound {m['bound_ms']:.4f} ms by {m['bound_by']} (bytes "
        f"{m['bytes']:.3e} -> {m['bytes_ms']:.4f} ms at 3.35 TB/s; FFT-form operations "
        f"{m['ops']:.3e} -> {m['ops_ms']:.4f} ms at 67 TFLOP/s f32); kernel at "
        f"{100 * m['bound_ms'] / m['ms']:.1f} % of its bound; the folded DFT this kernel "
        f"computes {m['fold_ops']:.3e} operations -> {m['fold_ops_ms']:.4f} ms (kernel at "
        f"{100 * m['fold_ops_ms'] / m['ms']:.1f} % of that floor); the dense DFT form of "
        f"the earlier design {m['dft_ops']:.3e} -> {m['dft_ops_ms']:.4f} ms")
    return main, err


def _condition_on_host(raw: np.ndarray, scale: float) -> np.ndarray:
    """The conditioned wire as the host readers produce it: demean each
    channel, scale to strain, float32 (row blocks keep the float64
    temporaries small)."""
    out = np.empty(raw.shape, np.float32)
    for lo in range(0, raw.shape[0], 2048):
        r = raw[lo : lo + 2048].astype(np.float64)
        out[lo : lo + 2048] = (r - r.mean(axis=1, keepdims=True)) * scale
    return out


def phase_spectro(scene, raw, design):
    import torch

    from das4whales_tpu_torch.eval import SpectroEvalAdapter
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.models.spectro import FUSED_DEFAULT_BATCH, SpectroCorrDetector

    nx, ns = raw.shape
    meta = scene.metadata
    t0 = time.perf_counter()
    cond = _condition_on_host(raw, meta.scale_factor)
    t_cond = time.perf_counter() - t0
    # the detect phase's design spares a second f-k design
    prefilter = MatchedFilterDetector.from_design(design, meta, wire="conditioned")
    det = SpectroCorrDetector(meta)
    adapter = SpectroEvalAdapter(prefilter, det)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    x = torch.as_tensor(cond).to("cuda")
    del cond
    n_chunks = -(-nx // FUSED_DEFAULT_BATCH)
    want_launches = len(det.kernels) * n_chunks

    adapter(x)                                # warm-up: cuFFT plans, kernel load
    torch.cuda.synchronize()
    zero_launches()                           # the main path's runs start here
    det.syncs = det.escalations = 0
    walls, stages, per_run = [], [], []
    res = None
    for _ in range(3):
        before = (read_launches()["fused_stft"], det.syncs, det.escalations)
        timer = StageTimer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = adapter(x, stage_hook=timer)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        stages.append(timer.walls())
        per_run.append((read_launches()["fused_stft"] - before[0], det.syncs - before[1],
                        det.escalations - before[2]))
    launches = read_launches()
    nK = len(det.kernels)
    for k, (n_launch, n_sync, n_esc) in enumerate(per_run):
        if n_launch != want_launches:
            fail(f"spectro: run {k} launched the STFT kernel {n_launch} times, expected "
                 f"{want_launches} ({nK} hat kernels x {n_chunks} chunks)")
        # a saturation check and a packed fetch per hat kernel, one more read
        # per escalation, at most one more per kernel on a capacity overflow
        if not 2 * nK + n_esc <= n_sync <= 3 * nK + n_esc:
            fail(f"spectro: run {k} made {n_sync} device->host reads with {n_esc} escalations")
    for name, p in res.picks.items():
        if p.ndim != 2 or p.shape[0] != 2:
            fail(f"spectro: kernel {name} returned picks of shape {p.shape}")
        if not (np.all((p[0] >= 0) & (p[0] < nx)) and np.all((p[1] >= 0) & (p[1] <= ns))):
            fail(f"spectro: kernel {name} has picks outside the block")
    misses = _check_calls(scene, res.picks)
    if misses:
        fail(f"spectro: injected calls not picked on their nearest channel within 1 s: {misses}")
    med = {k: statistics.median(s[k] for s in stages) for k in stages[0]}
    wall = statistics.median(walls)
    say(f"spectro: {nx}x{ns} conditioned float32, SpectroEvalAdapter(from_design prefilter, "
        f"SpectroCorrDetector defaults: window {det.win_size} s, overlap {det.overlap_pct}, "
        f"threshold {det.threshold}, kernels {'/'.join(det.kernels)}, engine "
        f"{det.stft_engine!r}, {n_chunks} chunks of {FUSED_DEFAULT_BATCH}); median wall "
        f"{wall * 1e3:.1f} ms (runs {', '.join(f'{w * 1e3:.1f}' for w in walls)} ms); stage "
        f"walls (median, CUDA events, summed over chunks) "
        f"{json.dumps({k: round(v, 3) for k, v in med.items()})} ms; per run (fused_stft "
        f"launches, device->host reads, escalations) {per_run}; picks "
        f"{json.dumps({k: int(v.shape[1]) for k, v in res.picks.items()})}; all "
        f"{len(scene.calls)} injected calls picked; host conditioning {t_cond:.1f} s; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _profile("SpectroEvalAdapter call", lambda: adapter(x), wall, "fused_stft")
    return launches["fused_stft"]


def phase_spectro_cpu_vs_card():
    """The spectro family on the card against the CPU, in both bandpass
    modes, on one design: correlograms within 1e-4 * max|cpu|, frame-unit
    picks equal up to rounding knife edges of the correlogram."""
    import torch

    from das4whales_tpu_torch.eval import SpectroEvalAdapter
    from das4whales_tpu_torch.io.synth import synthesize_scene, to_raw_counts
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.models.spectro import SpectroCorrDetector
    from das4whales_tpu_torch.utils.parity import unexplained_differences
    from das4whales_tpu_torch.workflows.spectrodetect import campaign_detector

    nx, ns = 512, CANONICAL[1]
    scene = _scene(nx, ns, n_calls=1, seed=SEED + 1)
    cond = _condition_on_host(to_raw_counts(synthesize_scene(scene), scene.metadata),
                              scene.metadata.scale_factor)
    notes, worst = [], 0.0
    for fused in (True, False):
        card = campaign_detector(scene.metadata, [0, nx, 1], (nx, ns), fused_bandpass=fused)
        cpu = SpectroEvalAdapter(
            MatchedFilterDetector.from_design(card.prefilter.design, scene.metadata,
                                              fused_bandpass=fused, device="cpu"),
            SpectroCorrDetector(scene.metadata, device="cpu"))
        out = {}
        for dev, ad in (("cuda", card), ("cpu", cpu)):
            out[dev] = ad.det(ad.prefilter.filter_block(cond))
        n_diff = 0
        for name, c_cpu in out["cpu"][0].items():
            c_cpu = c_cpu.numpy()
            c_card = out["cuda"][0][name].cpu().numpy()
            err = float(np.abs(c_card - c_cpu).max())
            scale = float(np.abs(c_cpu).max())
            worst = max(worst, err / scale)
            if not err <= 1e-4 * scale:
                fail(f"spectro_cpu_vs_card: fused_bandpass={fused}: kernel {name} correlograms "
                     f"differ by {err:.3e} > 1e-4 * {scale:.3e}")
            a, b = out["cuda"][1][name], out["cpu"][1][name]
            bad = unexplained_differences(a, b, c_cpu, card.det.threshold)
            if bad:
                fail(f"spectro_cpu_vs_card: fused_bandpass={fused}: kernel {name}: picks "
                     f"differ beyond rounding at {bad[:10]}")
            n_diff += len({tuple(p) for p in a.T.tolist()} ^ {tuple(p) for p in b.T.tolist()})
        if out["cuda"][2] != out["cpu"][2]:
            fail(f"spectro_cpu_vs_card: spectro_fs {out['cuda'][2]} vs {out['cpu'][2]}")
        res = card(cond)                     # the adapter itself, in sample units
        if _check_calls(scene, res.picks):
            fail(f"spectro_cpu_vs_card: fused_bandpass={fused}: the injected call was not "
                 f"picked on the card")
        notes.append(f"fused_bandpass={fused}: picks "
                     f"{json.dumps({k: int(v.shape[1]) for k, v in out['cuda'][1].items()})} on "
                     f"the card, {n_diff} differing")
        torch.cuda.synchronize()
    say(f"spectro_cpu_vs_card: {nx}x{ns}, correlograms within 1e-4 * max|cpu| (measured max "
        f"relative error {worst:.3e}), differing picks all on rounding knife edges; "
        f"{'; '.join(notes)}")


#: the slab phase's files: four canonical OOI blocks and a shorter one,
#: in one pow2 bucket of 16384 samples (22050 x 12000 and x 11000 raw int32)
SLAB_FILES = ((2026, 12000), (2028, 12000), (2029, 12000), (2030, 12000), (2031, 11000))
SLAB_BATCH = 4
SLAB_BUCKET = 16384
CARD_BYTES = 80e9


def _write_files(d, specs, nx, n_calls, float_file=None, k0: int = 0):
    """Silixa TDMS files of ``(seed, ns)`` scenes' raw int32 counts, through
    the port's writer (the card's machine has no ``h5py``, so no HDF5);
    returns ``(paths, scenes, seconds)``. ``float_file(raw)`` turns the
    last file's counts into a float32 block (written as float32). ``k0``
    numbers the first file (a list written in parts)."""
    from datetime import datetime

    from das4whales_tpu_torch.io.synth import synthesize_scene, to_raw_counts
    from das4whales_tpu_torch.io.tdms import write_tdms

    t0 = time.perf_counter()
    paths, scenes = [], []
    for k, (seed, ns) in enumerate(specs, start=k0):
        scene = _scene(nx, ns, n_calls=n_calls, seed=seed)
        raw = to_raw_counts(synthesize_scene(scene), scene.metadata)
        if float_file is not None and k == k0 + len(specs) - 1:
            raw = float_file(raw)
        props = {"SamplingFrequency[Hz]": float(scene.fs), "SpatialResolution[m]": float(scene.dx),
                 "FibreIndex": float(scene.n), "GaugeLength": float(scene.gauge_length),
                 "GPSTimeStamp": datetime(2021, 11, 4, 1, 59, 2 + k)}
        paths.append(write_tdms(str(d / f"file{k}_seed{seed}.tdms"), props, "Measurement",
                                {f"ch{i:05d}": raw[i] for i in range(nx)}))
        scenes.append(scene)
        del raw
    return paths, scenes, time.perf_counter() - t0


def _rms64(block: np.ndarray) -> float:
    """float64 rms of a host block, in row chunks."""
    acc = 0.0
    for lo in range(0, block.shape[0], 2048):
        r = block[lo : lo + 2048].astype(np.float64)
        acc += float(np.sum(r * r))
    return float(np.sqrt(acc / block.size))


def _within_ulp(a: float, b: float) -> bool:
    a, b = np.float32(a), np.float32(b)
    return bool(abs(a - b) <= np.spacing(max(abs(a), abs(b))))


def _slab_pass(stream, bd, with_refs=None, keep_first: bool = False):
    """One pass over the slab stream: dispatch + resolve each slab as it
    arrives. Returns per-slab records and the pass's wall. ``with_refs``
    (a detector) also computes each file's ``detect_picks`` reference and
    float64 rms, outside the pass's timing. ``keep_first`` keeps the first
    slab's stack on the card in its record (``"stack"``)."""
    import torch

    from das4whales_tpu_torch.ops import fused_picks

    det = bd.det
    slabs, refs = [], []
    t0 = time.perf_counter()
    t_ref = 0.0
    t_prev = t0
    for slab in stream:
        t_got = time.perf_counter()
        before = (fused_picks.launches, det.syncs, det.dispatches, det.escalations)
        res = bd.dispatch_batch(slab.stack, n_real=slab.n_real, n_valid=slab.n_valid,
                                with_health=True).resolve()
        t_done = time.perf_counter()
        slabs.append(dict(
            res=res, n_valid=slab.n_valid, n_real=slab.n_real, index0=slab.index0,
            copies=slab.copies, wait_s=t_got - t_prev, detect_s=t_done - t_got,
            read_s=[b.read_s for b in slab.blocks], cond_s=[b.condition_s for b in slab.blocks],
            launches=fused_picks.launches - before[0], syncs=det.syncs - before[1],
            dispatches=det.dispatches - before[2], escalations=det.escalations - before[3]))
        if keep_first and len(slabs) == 1:
            slabs[0]["stack"] = slab.stack
        if with_refs is not None:
            t1 = time.perf_counter()
            for j in range(slab.n_valid):
                r = with_refs.detect_picks(slab.stack[j], n_real=slab.n_real[j], with_health=True)
                refs.append((r, _rms64(np.asarray(slab.blocks[j].trace))))
            torch.cuda.synchronize()
            t_ref += time.perf_counter() - t1
        del slab
        t_prev = time.perf_counter()
    torch.cuda.synchronize()
    return slabs, refs, time.perf_counter() - t0 - t_ref


#: the slab phase's TDMS files, written once and shared with the campaign
#: and gabor phases (``slab_files``); removed at the end of the run
_SHARED: dict = {}

#: the slab phase's fin design at the 16384 bucket, kept for the gabor
#: phase's batched-peak measurement (a design is about 40 s of host work)
_SLAB_DESIGN: dict = {}


def slab_files() -> dict:
    """The five canonical TDMS files of the ``slab`` and ``campaign``
    phases, written on first use under ``build/``: ``{"dir", "paths",
    "scenes", "t_write", "picks"}``, where ``picks`` collects the slab
    phase's batched picks a file (trimmed to the file's samples)."""
    import tempfile
    from pathlib import Path

    if "paths" not in _SHARED:
        if "dir" not in _SHARED:
            root = Path(__file__).resolve().parent / "build"
            root.mkdir(exist_ok=True)
            _SHARED["dir"] = Path(tempfile.mkdtemp(prefix="slab_files_", dir=root))
        d = _SHARED["dir"]
        if "slab_file0" in _EARLY:
            _EARLY["slab_files"] = _JoinedFiles(
                [_EARLY.pop(f"slab_file{k}") for k in range(len(SLAB_FILES))])
        t_write, (paths, scenes) = _early("slab_files", lambda: _write_files(
            d, SLAB_FILES, CANONICAL[0], n_calls=6)[:2])
        _SHARED.update(paths=paths, scenes=scenes, t_write=t_write, picks={})
    return _SHARED


def remove_slab_files() -> None:
    import shutil

    if "dir" in _SHARED:   # a run that failed before the slab files has none
        shutil.rmtree(_SHARED["dir"], ignore_errors=True)
    _SHARED.clear()


def phase_slab():
    """The campaign's default batched route at full width: five TDMS
    files streamed into [4, 22050, 16384] slabs through pinned memory,
    detected by BatchedMatchedFilterDetector with the health stats, in
    the batched and the serial mode."""
    import torch

    from das4whales_tpu_torch.config import DataHealthConfig
    from das4whales_tpu_torch.io.stream import stream_batched_slabs
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.ops import fused_picks
    from das4whales_tpu_torch.parallel.batch import BatchedMatchedFilterDetector, trim_picks

    t_phase = time.perf_counter()
    nx = CANONICAL[0]
    sel = [0, nx, 1]
    shared = slab_files()
    paths, scenes, t_write = shared["paths"], shared["scenes"], shared["t_write"]
    meta = scenes[0].metadata
    t_design, design = _early("slab_design", lambda: MatchedFilterDetector(
        meta, sel, (nx, SLAB_BUCKET), templates="fin", device="cpu").design)
    ref = MatchedFilterDetector.from_design(design, meta, wire="conditioned")
    _SLAB_DESIGN["design"] = ref.design      # the gabor phase's batched bucket reuses it
    tile = ref.effective_channel_tile
    n_tiles = -(-nx // tile)
    nT = ref.design.templates.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def stream():
        return stream_batched_slabs(paths, sel, meta, batch=SLAB_BATCH, bucket="pow2",
                                    device="cuda")

    refs, out, launch_by_mode, kernel_err = None, {}, {}, 0.0
    for mode, serial in (("batched", False), ("serial", True)):
        det = MatchedFilterDetector.from_design(ref.design, meta, wire="conditioned")
        bd = BatchedMatchedFilterDetector(det, serial=serial)
        if refs is None:
            # warm-up pass: FFT plans, allocator pools; the references ride it
            _, refs, _ = _slab_pass(stream(), bd, with_refs=ref)
        else:
            # the serial mode runs the references' single-file programs, warm
            # from that pass: one noise slab warms this facade without reading
            # the files a third time (a cut for the run's time limit)
            noise = torch.randn((SLAB_BATCH, nx, SLAB_BUCKET), device="cuda") * 1e-9
            bd.dispatch_batch(noise, n_real=[CANONICAL[1]] * SLAB_BATCH,
                              with_health=True).resolve()
            del noise
        zero_launches()                          # the main path's timed pass starts here
        det.syncs = det.dispatches = det.escalations = 0
        slabs, _, wall = _slab_pass(stream(), bd, keep_first=True)
        launch_by_mode[mode] = read_launches()["fused_picks"]
        # per-file checks against detect_picks on the same card
        files = [(s, j) for s in slabs for j in range(s["n_valid"])]
        if len(files) != len(SLAB_FILES) or [s["n_valid"] for s in slabs] != [4, 1]:
            fail(f"slab: {mode}: slabs of {[s['n_valid'] for s in slabs]} files, "
                 "expected a full slab of 4 and a partial slab of 1")
        health_cfg = DataHealthConfig()
        for k, (s, j) in enumerate(files):
            picks, thr, health = s["res"][j]
            rref, rms64 = refs[k]
            n_real = s["n_real"][j]
            a, b = trim_picks(picks, n_real), trim_picks(rref.picks, n_real)
            for name in b:
                if not np.array_equal(a[name], b[name]):
                    fail(f"slab: {mode}: file {k} template {name}: picks differ from "
                         f"detect_picks ({a[name].shape[1]} vs {b[name].shape[1]})")
                same = (thr[name] == rref.thresholds[name] if serial
                        else _within_ulp(thr[name], rref.thresholds[name]))
                if not same:
                    fail(f"slab: {mode}: file {k} template {name}: threshold "
                         f"{thr[name]!r} vs detect_picks {rref.thresholds[name]!r}")
            if serial and health != rref.health:
                fail(f"slab: {mode}: file {k}: health differs from detect_picks")
            if mode == "batched":
                shared["picks"][k] = a       # the campaign phase holds its picks to these
            misses = _check_calls(scenes[k], a)
            if misses:
                fail(f"slab: {mode}: file {k}: injected calls missed: {misses}")
            if health["nonfinite"] or health["clipped"]:
                fail(f"slab: {mode}: file {k}: health {health['nonfinite']} non-finite, "
                     f"{health['clipped']} clipped")
            if abs(health["rms"] - rms64) > 1e-5 * rms64:
                fail(f"slab: {mode}: file {k}: rms {health['rms']!r} vs float64 {rms64!r}")
            if health_cfg.breach(health) is not None:
                fail(f"slab: {mode}: file {k}: breach {health_cfg.breach(health)}")
        for s in slabs:
            want = n_tiles * s["dispatches"] * (s["n_valid"] if serial else 1)
            if s["syncs"] != s["dispatches"] or s["dispatches"] != 1 + s["escalations"]:
                fail(f"slab: {mode}: {s['syncs']} reads for {s['dispatches']} attempts "
                     f"({s['escalations']} escalations)")
            if s["launches"] != want:
                fail(f"slab: {mode}: {s['launches']} fused_picks launches in a slab of "
                     f"{s['n_valid']} files, expected {want}")
        # the first (full) slab again, kept on the card from the timed pass
        # (not read a second time: a cut for the run's time limit): detect
        # wall, stages
        first = types.SimpleNamespace(stack=slabs[0].pop("stack"), n_real=slabs[0]["n_real"],
                                      n_valid=slabs[0]["n_valid"])
        walls, stages = [], []
        for _ in range(3):
            timer = StageTimer()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bd.dispatch_batch(first.stack, n_real=first.n_real, n_valid=first.n_valid,
                              with_health=True, stage_hook=timer).resolve()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            stages.append(timer.walls())
        detect_wall = statistics.median(walls)
        n_first = first.n_valid
        med = {k: statistics.median(st[k] for st in stages) for k in stages[0]}
        fams = _profile(f"{mode} slab of {first.n_valid}", lambda: bd.dispatch_batch(
            first.stack, n_real=first.n_real, n_valid=first.n_valid,
            with_health=True).resolve(), detect_wall, "fused_picks")
        # the pick kernel on the inputs this mode gives it: the first
        # (a full tile) and the last (the ragged tile) launch of the
        # first slab, with the files' own thresholds, against its plain
        # version; these launches are not the main path's
        with _capture(fused_picks, "picks_cuda") as calls:
            bd.dispatch_batch(first.stack, n_real=first.n_real, n_valid=first.n_valid,
                              with_health=True).resolve()
        lanes = 1 if serial else n_first         # files a launch carries
        err, notes = _picks_at_main_path(f"slab: {mode}", calls, {
            "first": nT * lanes * tile, "last": nT * lanes * (nx - (n_tiles - 1) * tile)})
        kernel_err = max(kernel_err, err)
        say(f"slab: {mode}: fused_picks == plain, bitwise on all five outputs, on the "
            f"first slab's first and last launch ({calls['n']} launches in the "
            f"dispatch): {'; '.join(notes)}")
        del first, calls
        copies = [[(a.elapsed_time(b), n) for a, b, n in s["copies"]] for s in slabs]
        out[mode] = dict(slabs=slabs, wall=wall, detect_wall=detect_wall, stages=med,
                         copies=copies, busy=sum(fams.values()))
        h2d = [sum(ms for ms, _ in c) for c in copies]
        nbytes = [sum(n for _, n in c) for c in copies]
        read = [x for s in slabs for x in s["read_s"]]
        cond = [x for s in slabs for x in s["cond_s"]]
        detect = [s["detect_s"] for s in slabs]
        parts = sum(read) + sum(cond) + sum(h2d) / 1e3 + sum(detect)
        say(f"slab: {mode} (serial={serial}), {len(SLAB_FILES)} files in slabs of "
            f"{[s['n_valid'] for s in slabs]}, bucket {SLAB_BUCKET}, TDMS int32, conditioned "
            f"wire, format reader (engine='h5py'), with_health: slab detect wall (dispatch to resolve, slab on the "
            f"card, median of 3) {detect_wall * 1e3:.1f} ms (runs "
            f"{', '.join(f'{w * 1e3:.1f}' for w in walls)}) = "
            f"{detect_wall * 1e3 / n_first:.1f} ms a file; stage walls (median, CUDA "
            f"events) {json.dumps({k: round(v, 3) for k, v in med.items()})} ms, of which "
            f"health {med.get('health', 0.0):.3f} ms; device busy "
            f"{100 * out[mode]['busy'] / (detect_wall * 1e3):.1f} % of the detect wall "
            f"(profiler); per file host read s {[round(x, 3) for x in read]}, host "
            f"conditioning s {[round(x, 3) for x in cond]}; per slab H2D "
            f"{[round(x, 3) for x in h2d]} ms, "
            f"{[round(n / (ms * 1e6), 2) for n, ms in zip(nbytes, h2d)]} GB/s, bytes "
            f"{nbytes}; per slab detect (host clock, dispatch to resolve) "
            f"{[round(x * 1e3, 1) for x in detect]} ms, wait for the slab "
            f"{[round(s['wait_s'] * 1e3, 1) for s in slabs]} ms; timed pass (stream + "
            f"detect) {wall:.3f} s = {wall / len(SLAB_FILES):.3f} s a file against a sum of "
            f"parts (read + conditioning + H2D + detect) {parts:.3f} s: {parts - wall:.3f} s "
            f"hidden by overlap; per slab (fused_picks launches, reads, attempts, "
            f"escalations) {[(s['launches'], s['syncs'], s['dispatches'], s['escalations']) for s in slabs]}; "
            f"picks equal detect_picks on the card for every file "
            f"({'bitwise, thresholds equal' if serial else 'thresholds within 1 ulp'}), all "
            f"injected calls picked, health 0 non-finite, 0 clipped, rms within 1e-5 of "
            f"float64, no breach")
        del bd, det
    # the same batched pass with the native reader (engine="native": the
    # C++ fused read, demean and scale) in place of the format reader
    det = MatchedFilterDetector.from_design(ref.design, meta, wire="conditioned")
    bd = BatchedMatchedFilterDetector(det, serial=False)
    slabs, _, wall_native = _slab_pass(stream_batched_slabs(
        paths, sel, meta, batch=SLAB_BATCH, bucket="pow2", engine="native",
        device="cuda"), bd)
    files = [(s, j) for s in slabs for j in range(s["n_valid"])]
    for k, (s, j) in enumerate(files):
        misses = _check_calls(scenes[k], trim_picks(s["res"][j][0], s["n_real"][j]))
        if misses:
            fail(f"slab: native reader: file {k}: injected calls missed: {misses}")
    say(f"slab: batched, engine='native' (the C++ fused read, demean and scale): timed pass "
        f"{wall_native:.3f} s = {wall_native / len(files):.3f} s a file; host read (fused) "
        f"s {[round(x, 3) for s in slabs for x in s['read_s']]}; per slab detect "
        f"{[round(s['detect_s'] * 1e3, 1) for s in slabs]} ms, wait for the slab "
        f"{[round(s['wait_s'] * 1e3, 1) for s in slabs]} ms; all injected calls picked")
    del bd, det
    peak = torch.cuda.max_memory_allocated()
    if peak >= CARD_BYTES:
        fail(f"slab: peak device memory {peak / 1e9:.2f} GB, over the card's 80 GB")
    # the host's read ceiling: the stream alone on the native engine, the
    # raw wire (counts to the card) and the conditioned wire (the C++
    # reader's fused demean and scale)
    alone = {}
    for wire in ("raw", "conditioned"):
        t0 = time.perf_counter()
        n = 0
        for slab in stream_batched_slabs(paths, sel, meta, batch=SLAB_BATCH, bucket="pow2",
                                         wire=wire, engine="native", device="cuda"):
            n += slab.n_valid
            del slab
        torch.cuda.synchronize()
        alone[wire] = (time.perf_counter() - t0) / n
    say(f"slab: the host's read ceiling, the stream alone on the native engine (5 files "
        f"to the card): wire='raw' (int32 counts) {alone['raw']:.3f} s a file, "
        f"wire='conditioned' (the C++ fused read, demean and scale) "
        f"{alone['conditioned']:.3f} s a file; peak device memory over the phase "
        f"{peak / 2**30:.2f} GiB; files written in {t_write:.1f} s; f-k design at the "
        f"bucket shape {t_design:.1f} s (host); phase {time.perf_counter() - t_phase:.1f} s")
    return launch_by_mode, kernel_err
#: the card-vs-CPU slab files: three int32 blocks and a float32 one with
#: NaNs and samples at the clip level
SLAB_CPU_FILES = ((2027, 12000), (2032, 12000), (2033, 12000), (2034, 11000))
CLIP_COUNTS = 3000.0
N_NAN, N_CLIP = 3, 5


def _poison(raw: np.ndarray) -> np.ndarray:
    """float32 counts with N_NAN NaNs (one a channel) and N_CLIP samples at
    +-CLIP_COUNTS, all inside the record."""
    x = raw.astype(np.float32)
    for i in range(N_NAN):
        x[10 + 100 * i, 500 + 7 * i] = np.nan
    for i in range(N_CLIP):
        x[50 + 90 * i, 2000 + 11 * i] = CLIP_COUNTS * (1 if i % 2 else -1)
    return x


def phase_slab_cpu_vs_card():
    """The slab route on the card against the CPU at 512 channels, both
    wires, with the health stats and a clip level; then the spectro
    facade on one slab against its per-file adapter on the card."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from das4whales_tpu_torch.config import DataHealthConfig
    from das4whales_tpu_torch.io.stream import stream_batched_slabs, stream_strain_blocks
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.models.spectro import FUSED_DEFAULT_BATCH
    from das4whales_tpu_torch.ops import conditioning, fused_stft
    from das4whales_tpu_torch.parallel.batch import BatchedMatchedFilterDetector, batched_detector_for
    from das4whales_tpu_torch.utils.parity import envelopes, unexplained_differences
    from das4whales_tpu_torch.workflows.spectrodetect import campaign_detector

    nx = 512
    sel = [0, nx, 1]
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    d = Path(tempfile.mkdtemp(prefix="slab_cpu_files_", dir=root))
    notes = []
    try:
        paths, scenes, _ = _write_files(d, SLAB_CPU_FILES, nx, n_calls=1, float_file=_poison)
        meta = scenes[0].metadata
        design = MatchedFilterDetector(meta, sel, (nx, SLAB_BUCKET), device="cpu").design
        for wire in ("raw", "conditioned"):
            clip = CLIP_COUNTS if wire == "raw" else 0.8 * CLIP_COUNTS * meta.scale_factor
            cfg = DataHealthConfig(clip_abs=clip)
            res, shapes = {}, {}
            for dev in ("cuda", "cpu"):
                det = MatchedFilterDetector.from_design(design, meta, wire=wire, device=dev)
                bd = BatchedMatchedFilterDetector(det)
                res[dev], shapes[dev] = [], []
                for slab in stream_batched_slabs(paths, sel, meta, batch=2, bucket="pow2",
                                                 wire=wire, device=dev):
                    shapes[dev].append((slab.n_valid, str(slab.stack.dtype)))
                    got = bd.detect_batch(slab.stack, n_real=slab.n_real, n_valid=slab.n_valid,
                                          with_health=True, health_clip=clip)
                    res[dev] += [(r, slab.stack[j].cpu(), slab.n_real[j])
                                 for j, r in enumerate(got)]
                if bd.serial is not (dev == "cpu"):
                    fail(f"slab_cpu_vs_card: the {dev} facade resolved serial={bd.serial}")
            want_shapes = ([(2, "torch.int32"), (1, "torch.int32"), (1, "torch.float32")]
                           if wire == "raw" else [(2, "torch.float32"), (2, "torch.float32")])
            if shapes["cuda"] != shapes["cpu"] or shapes["cuda"] != want_shapes:
                fail(f"slab_cpu_vs_card: {wire}: slabs {shapes}, expected {want_shapes}")
            n_diff = 0
            cpu_det = MatchedFilterDetector.from_design(design, meta, wire="conditioned",
                                                        device="cpu")
            for k, ((gp, gt, gh), block, n_real), ((cp, ct, ch), _, _) in zip(
                    range(len(paths)), res["cuda"], res["cpu"]):
                for key in ("nonfinite", "clipped", "bin_nonfinite", "bin_clipped", "bin_dead",
                            "n_samples"):
                    if gh[key] != ch[key]:
                        fail(f"slab_cpu_vs_card: {wire}: file {k}: health {key} card "
                             f"{gh[key]} vs cpu {ch[key]}")
                poisoned = k == len(paths) - 1
                if wire == "raw" and poisoned and (gh["nonfinite"], gh["clipped"]) != (N_NAN, N_CLIP):
                    fail(f"slab_cpu_vs_card: raw: the float32 file reads {gh['nonfinite']} "
                         f"non-finite and {gh['clipped']} clipped, expected {N_NAN} and {N_CLIP}")
                if (cfg.breach(gh) is not None) != poisoned or (cfg.breach(ch) is not None) != poisoned:
                    fail(f"slab_cpu_vs_card: {wire}: file {k}: breach card {cfg.breach(gh)!r}, "
                         f"cpu {cfg.breach(ch)!r}")
                x = block
                if wire == "raw":
                    x = conditioning.condition_padded(x, det._cond_scale, int(n_real))
                env = None
                for i, name in enumerate(cp):
                    a, b = gp[name], cp[name]
                    if not (np.isclose(gt[name], ct[name], rtol=1e-5, atol=0)
                            or (poisoned and np.isnan(gt[name]) and np.isnan(ct[name]))):
                        fail(f"slab_cpu_vs_card: {wire}: file {k} template {name}: threshold "
                             f"card {gt[name]} vs cpu {ct[name]}")
                    if not np.array_equal(a, b):
                        env = envelopes(cpu_det, x) if env is None else env
                        bad = unexplained_differences(a, b, env[i], ct[name])
                        if bad:
                            fail(f"slab_cpu_vs_card: {wire}: file {k} template {name}: picks "
                                 f"differ beyond rounding at {bad[:10]}")
                        n_diff += len({tuple(p) for p in a.T.tolist()}
                                      ^ {tuple(p) for p in b.T.tolist()})
                if not poisoned and _check_calls(scenes[k], gp):
                    fail(f"slab_cpu_vs_card: {wire}: file {k}: the injected call was missed")
            last = res["cuda"][-1][0][2]
            notes.append(f"{wire}: slabs {[s[0] for s in shapes['cuda']]} "
                         f"({', '.join(s[1] for s in shapes['cuda'])}), clip {clip:.4g}, the "
                         f"float32 file {last['nonfinite']} non-finite / {last['clipped']} "
                         f"clipped (breach), {n_diff} differing picks")
        # the per-block stream on the card (pinned staging from the read
        # workers, or at yield time): each block bit for bit its host read
        for wire in ("raw", "conditioned"):
            host = [np.ascontiguousarray(b.trace) for b in stream_strain_blocks(
                paths, sel, meta, wire=wire, as_numpy=True)]
            for overlap in (True, False):
                card = [b.trace for b in stream_strain_blocks(
                    paths, sel, meta, wire=wire, device="cuda", overlap_transfers=overlap)]
                same = [c.is_cuda and c.cpu().numpy().tobytes() == h.tobytes()
                        for c, h in zip(card, host)]
                if len(card) != len(host) or not all(same):
                    fail(f"slab_cpu_vs_card: stream_strain_blocks on the card, wire={wire}, "
                         f"overlap_transfers={overlap}: blocks equal to the host read {same}")
        notes.append("stream_strain_blocks on the card equal to the host read bit for bit "
                     "(both wires, with and without overlap)")
        # the spectro facade on one slab against its per-file adapter, on the card
        ad = campaign_detector(meta, sel, (nx, SLAB_BUCKET))
        bd = batched_detector_for(ad)
        slab = next(stream_batched_slabs(paths, sel, meta, batch=2, bucket="pow2"))
        zero_launches()                         # the facade's batched route starts here
        with _capture(fused_stft, "stft_power_cuda") as calls:
            got = bd.detect_batch(slab.stack, n_real=slab.n_real, n_valid=slab.n_valid)
        stft_launches = read_launches()["fused_stft"]
        rows = slab.n_valid * nx                # the facade's [n * C, T] correlogram input
        chunk = ad.det.batch_channels or FUSED_DEFAULT_BATCH
        want = len(ad.det.kernels) * -(-rows // chunk)
        if stft_launches != want:
            fail(f"slab_cpu_vs_card: the spectro facade launched fused_stft {stft_launches} "
                 f"times, expected {want} ({len(ad.det.kernels)} hat kernels x "
                 f"{-(-rows // chunk)} chunks of {rows} channels)")
        # the STFT kernel on the facade's own launches, against its plain version
        shape = (min(rows, chunk), SLAB_BUCKET)
        stft_err, rel, (nfft, hop) = _stft_at_main_path("slab_cpu_vs_card", calls, shape)
        notes.append(f"BatchedSpectroDetector: {stft_launches} fused_stft launches on the slab "
                     f"of {slab.n_valid}; fused_stft within {STFT_REL_TOL} * max of its plain "
                     f"version at the facade's first and last launch {shape} nfft {nfft} hop "
                     f"{hop} (relative max error {rel:.2e})")
        del calls
        n_diff = n_picks = 0
        for j in range(slab.n_valid):
            one = ad(slab.stack[j])
            corr = ad.det.correlograms(ad.prefilter.filter_block(slab.stack[j]))
            for name, b in one.picks.items():
                a = got[j][0][name]
                n_picks += b.shape[1]
                if np.array_equal(a, b):
                    continue
                env = corr[name].cpu().numpy()
                k_ = meta.ns / env.shape[-1]      # the adapter's frame -> sample factor
                fa, fb = (np.stack([p[0], np.round(p[1] / k_).astype(int)]) for p in (a, b))
                bad = unexplained_differences(fa, fb, env, ad.det.threshold)
                if bad:
                    fail(f"slab_cpu_vs_card: spectro facade file {j} kernel {name}: picks "
                         f"differ from the adapter beyond rounding at {bad[:10]}")
                n_diff += len({tuple(p) for p in fa.T.tolist()} ^ {tuple(p) for p in fb.T.tolist()})
        if n_picks == 0:
            fail("slab_cpu_vs_card: the spectro adapter picked nothing; the comparison proves nothing")
        del slab
        torch.cuda.synchronize()
        notes.append(f"BatchedSpectroDetector (serial={bd.serial}) on one slab of 2: "
                     f"{n_picks} adapter picks, {n_diff} differing")
        say(f"slab_cpu_vs_card: {nx} channels, files {[ns for _, ns in SLAB_CPU_FILES]} "
            f"samples, batch 2, pow2 bucket {SLAB_BUCKET}, card (batched mode) vs CPU (serial "
            f"mode): thresholds within rtol 1e-5, differing picks all on rounding knife edges, "
            f"health counts equal; {'; '.join(notes)}")
        return stft_launches, stft_err
    finally:
        shutil.rmtree(d, ignore_errors=True)



@contextlib.contextmanager
def _timing(mod, name: str, keep: bool = False):
    """Replace ``mod.name`` for the block by a function that forwards every
    call, counting the calls and summing their host seconds; with
    ``keep`` it also keeps each call's result. Yields ``{"n", "s",
    "out"}``."""
    orig = getattr(mod, name)
    got = {"n": 0, "s": 0.0, "out": []}

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = orig(*args, **kw)
        got["s"] += time.perf_counter() - t0
        got["n"] += 1
        if keep:
            got["out"].append(out)
        return out

    setattr(mod, name, timed)
    try:
        yield got
    finally:
        setattr(mod, name, orig)


@contextlib.contextmanager
def _first_slab(stream_mod):
    """Count ``stream_batched_slabs`` calls for the block and keep the host
    blocks of the first slab they yield: ``{"calls", "slab"}``."""
    orig = stream_mod.stream_batched_slabs
    got = {"calls": 0, "slab": None}

    def spy(*args, **kw):
        got["calls"] += 1
        gen = orig(*args, **kw)
        try:
            for slab in gen:
                if got["slab"] is None:
                    got["slab"] = (slab.blocks, slab.paths, slab.n_real, slab.bucket_ns)
                yield slab
        finally:
            gen.close()

    stream_mod.stream_batched_slabs = spy
    try:
        yield got
    finally:
        stream_mod.stream_batched_slabs = orig


@contextlib.contextmanager
def _pipeline_probe(cls):
    """Replace ``cls.dispatch_batch`` for the block by a function that
    forwards every call and keeps, per dispatched slab: the host seconds
    of the dispatch; CUDA events recorded just before and just after it
    on the dispatching stream (the slab's device time between them);
    the host clock at its resolve's start and its seconds; whether its
    own program had finished when its resolve started
    (``done_at_resolve``); and whether the NEXT slab's program was still
    running when its resolve started and when it returned
    (``next_busy``, a pair; None for the last slab). Yields the list of
    slabs."""
    import torch

    orig = cls.dispatch_batch
    slabs = []

    def spy(self, *args, **kw):
        k = len(slabs)
        rec = {"start": torch.cuda.Event(enable_timing=True),
               "end": torch.cuda.Event(enable_timing=True)}
        slabs.append(rec)
        rec["start"].record()
        rec["t_dispatch"] = time.perf_counter()
        handle = orig(self, *args, **kw)
        rec["dispatch_s"] = time.perf_counter() - rec["t_dispatch"]
        rec["end"].record()
        resolve = handle.resolve

        def probed():
            nxt = slabs[k + 1]["end"] if k + 1 < len(slabs) else None
            rec["t_resolve"] = time.perf_counter()
            rec["done_at_resolve"] = rec["end"].query()
            busy0 = nxt is not None and not nxt.query()
            out = resolve()
            rec["resolve_s"] = time.perf_counter() - rec["t_resolve"]
            rec["next_busy"] = None if nxt is None else (busy0, not nxt.query())
            return out

        handle.resolve = probed
        return handle

    cls.dispatch_batch = spy
    try:
        yield slabs
    finally:
        cls.dispatch_batch = orig


def _check_pipeline(where: str, slabs: list) -> str:
    """Hold a depth-2 campaign run to its pipeline's order (from
    :func:`_pipeline_probe`): slab k+1's program enqueued before slab k's
    fetch started. Returns the per-slab figures as text. How long a
    dispatch holds the host, and so whether slab k+1 still runs around
    slab k's fetch, depends on the host's pace and the launch queue: it
    is reported; :func:`_check_fetch_waits_on_its_slab` holds the fetch
    to its own slab."""
    parts = []
    for k, r in enumerate(slabs):
        dev_ms = r["start"].elapsed_time(r["end"])
        text = (f"slab {k}: dispatch {r['dispatch_s'] * 1e3:.1f} ms of host, program "
                f"{dev_ms:.1f} ms on the card (events around the dispatch), done when its "
                f"fetch started {r['done_at_resolve']}, fetch {r['resolve_s'] * 1e3:.1f} ms"
                + ("" if r["next_busy"] is None else
                   f", slab {k + 1} still running at that fetch's start, end "
                   f"{r['next_busy']}"))
        if k + 1 < len(slabs) and not slabs[k + 1]["t_dispatch"] < r["t_resolve"]:
            fail(f"{where}: slab {k + 1} was dispatched after slab {k}'s fetch started ({text})")
        parts.append(text)
    return "; ".join(parts)


def _check_fetch_waits_on_its_slab(where: str, bd, stack, **kw) -> str:
    """The pipeline's promises on one facade and slab, at depth 2: slab
    B's dispatch returns while its program still runs, and slab A's
    fetch, taken after B was queued, returns while B's kernels run (it
    waits on A's event, not on the stream). Returns the figures, with
    the host's lead: how long B ran on after its dispatch returned (the
    window the host has to settle slab A before the card idles)."""
    import torch

    torch.cuda.synchronize()
    h_a = bd.dispatch_batch(stack, **kw)
    start_b = torch.cuda.Event(enable_timing=True)
    end_b = torch.cuda.Event(enable_timing=True)
    start_b.record()
    t0 = time.perf_counter()
    h_b = bd.dispatch_batch(stack, **kw)
    t_back = time.perf_counter()
    end_b.record()
    busy_dispatched = not end_b.query()
    h_a.resolve()
    fetch_s = time.perf_counter() - t_back
    started, busy_fetched = start_b.query(), not end_b.query()
    end_b.synchronize()
    lead_s = time.perf_counter() - t_back
    h_b.resolve()
    torch.cuda.synchronize()
    text = (f"slab B's dispatch {(t_back - t0) * 1e3:.1f} ms of host against its program "
            f"{start_b.elapsed_time(end_b):.1f} ms on the card; slab A's fetch {fetch_s * 1e3:.1f} "
            f"ms; B still running after its dispatch {busy_dispatched}; B's kernels running "
            f"when A's fetch returned {started and busy_fetched}; B ran on {lead_s * 1e3:.1f} ms "
            f"after its dispatch returned (the host's lead)")
    if not busy_dispatched:
        fail(f"{where}: slab B's dispatch held the host until its program ended ({text})")
    if not (started and busy_fetched):
        fail(f"{where}: slab A's fetch did not return while slab B's kernels ran ({text})")
    return text


@contextlib.contextmanager
def _no_host_sync(cls, name: str):
    """Run every call of ``cls.name`` for the block under
    ``torch.cuda.set_sync_debug_mode("error")``: an operation inside it
    that would make the host wait on the card raises there. Yields
    ``{"n": calls, "syncs": [first line of each such error]}`` (a caller
    may swallow the error; the record stays)."""
    import torch

    orig = getattr(cls, name)
    got = {"n": 0, "syncs": []}

    def guarded(*args, **kw):
        got["n"] += 1
        torch.cuda.set_sync_debug_mode("error")
        try:
            return orig(*args, **kw)
        except RuntimeError as exc:
            if "synchroniz" in str(exc):
                got["syncs"].append(str(exc).splitlines()[0])
            raise
        finally:
            torch.cuda.set_sync_debug_mode(0)

    setattr(cls, name, guarded)
    try:
        yield got
    finally:
        setattr(cls, name, orig)


@contextlib.contextmanager
def _oom_full_bank(cls, n_templates: int):
    """For the block, ``cls.dispatch_batch`` of a detector with
    ``n_templates`` templates (the full bank) raises the injected resource
    error, as a card that cannot hold the full-bank slab program would;
    the sub-bank halves run."""
    from das4whales_tpu_torch import faults

    orig = cls.dispatch_batch

    def oom(self, *args, **kw):
        if self.det.design.templates.shape[0] == n_templates:
            raise faults.InjectedResourceExhausted(
                "injected: the full-bank slab program exhausts device memory")
        return orig(self, *args, **kw)

    cls.dispatch_batch = oom
    try:
        yield
    finally:
        cls.dispatch_batch = orig


def _downshifts(outdir) -> list:
    from das4whales_tpu_torch.utils.artifacts import read_records

    return [(e["from"], e["to"]) for e in read_records(str(outdir / "manifest.jsonl"))
            if e.get("event") == "downshift"]


def phase_campaign():
    """``run_campaign_batched`` at its defaults over the slab phase's five
    canonical TDMS files, then again on the same outdir (resume)."""
    import shutil

    import torch

    from das4whales_tpu_torch import fsck
    from das4whales_tpu_torch.config import dispatch_depth_default
    from das4whales_tpu_torch.io import stream as stream_mod
    from das4whales_tpu_torch.io.stream import assemble_slab
    from das4whales_tpu_torch.parallel.batch import (BatchedMatchedFilterDetector,
                                                     batched_detector_for)
    from das4whales_tpu_torch.telemetry import metrics
    from das4whales_tpu_torch.workflows import campaign as cmod

    t_phase = time.perf_counter()
    nx = CANONICAL[0]
    sel = [0, nx, 1]
    shared = slab_files()
    paths, scenes = shared["paths"], shared["scenes"]
    meta = scenes[0].metadata
    out = shared["dir"] / "campaign_out"
    shutil.rmtree(out, ignore_errors=True)
    def slab_wall_totals():
        rows = metrics.snapshot().get("das_slab_wall_seconds", {}).get("values", [])
        return sum(r["sum"] for r in rows), sum(r["count"] for r in rows)

    before_hist = slab_wall_totals()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()                      # the campaign's main path starts here
    with _timing(cmod, "family_detector", keep=True) as design_t, \
            _timing(cmod, "_save_picks") as picks_t, \
            _timing(cmod, "_append_manifest") as manifest_t, \
            _timing(cmod.fsck, "startup_check") as fsck_t, \
            _pipeline_probe(BatchedMatchedFilterDetector) as piped, \
            _no_host_sync(BatchedMatchedFilterDetector, "dispatch_batch") as guard, \
            _first_slab(stream_mod) as first:
        t0 = time.perf_counter()
        # the slab phase's design of this bucket where it ran (the bucket's
        # f-k design is 35-48 s of host, timed in PERF.md several times over;
        # a cut for the run's time limit)
        res = cmod.run_campaign_batched(paths, sel, str(out), metadata=meta,
                                        interrogator="silixa",
                                        design=_SLAB_DESIGN.get("design"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_launches()["fused_picks"]
    peak = torch.cuda.max_memory_allocated()
    hist = slab_wall_totals()
    slab_walls = (hist[0] - before_hist[0], hist[1] - before_hist[1])
    if design_t["n"] != 1:
        fail(f"campaign: {design_t['n']} detectors built for one bucket")
    det = design_t["out"][0]
    _SLAB_DESIGN["campaign"] = det.design    # the preflight and service phases reuse it
    attempts, reads, escalations = det.dispatches, det.syncs, det.escalations
    n_tiles = -(-nx // det.effective_channel_tile)
    recs = [(r.status, r.rung) for r in res.records]
    if recs != [("done", "batched:4")] * len(paths):
        fail(f"campaign: records {recs}; every file must be done at batched:4")
    moves = _downshifts(out)
    if moves:
        fail(f"campaign: downshift events {moves} on the canonical files")
    if attempts != 2 + escalations or reads != attempts:
        fail(f"campaign: {attempts} attempts and {reads} reads for 2 slabs "
             f"({escalations} escalations)")
    if launches != n_tiles * attempts:
        fail(f"campaign: {launches} fused_picks launches for {attempts} attempts, "
             f"expected {n_tiles} an attempt")
    if len(piped) != 2 or guard["syncs"]:
        fail(f"campaign: {len(piped)} pipelined dispatches for 2 slabs, host syncs inside "
             f"them: {guard['syncs']}")
    pipeline = _check_pipeline("campaign", piped)
    n_same = 0
    for k, rec in enumerate(res.records):
        got = cmod.load_picks(rec.picks_file)
        ref = shared["picks"].get(k)
        if ref is not None:
            for name in ref:
                if not np.array_equal(got[name], ref[name]):
                    fail(f"campaign: file {k} template {name}: saved picks differ from the "
                         f"slab phase's batched picks ({got[name].shape[1]} vs "
                         f"{ref[name].shape[1]})")
            n_same += 1
        misses = _check_calls(scenes[k], got)
        if misses:
            fail(f"campaign: file {k}: injected calls missed: {misses}")
    if shared["picks"] and n_same != len(paths):
        fail(f"campaign: {n_same} of {len(paths)} files held to the slab phase's picks")
    # resume: the same call settles nothing and reads nothing
    with _first_slab(stream_mod) as again:
        t0 = time.perf_counter()
        res2 = cmod.run_campaign_batched(paths, sel, str(out), metadata=meta,
                                         interrogator="silixa")
        resume_wall = time.perf_counter() - t0
    if [r.status for r in res2.records] != ["skipped"] * len(paths) or again["calls"]:
        fail(f"campaign: resume gave {[r.status for r in res2.records]} with "
             f"{again['calls']} streams; it must settle nothing and read nothing")
    summary = cmod.summarize_campaign(str(out))
    if summary["n_done"] != len(paths) or summary["downshifts"]:
        fail(f"campaign: summary counts {summary['n_done']} done, "
             f"{summary['downshifts']} downshifts")
    findings = fsck.fsck_outdir(str(out))
    if findings:
        fail(f"campaign: fsck found {fsck.render_findings(findings)}")
    # the device's busy share on one slab of the campaign's own facade
    blocks, spaths, n_real, bucket_ns = first["slab"]
    host = assemble_slab(blocks, spaths, 0, SLAB_BATCH, bucket_ns)
    stack = torch.from_numpy(host.stack).cuda()
    del host
    bd = batched_detector_for(det)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bd.dispatch_batch(stack, n_real=n_real, n_valid=len(blocks), with_health=True).resolve()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    slab_wall = statistics.median(walls)
    ab = _check_fetch_waits_on_its_slab("campaign", bd, stack, n_real=n_real,
                                        n_valid=len(blocks), with_health=True)
    fams = _profile("campaign slab of 4 (the campaign's own facade)", lambda: bd.dispatch_batch(
        stack, n_real=n_real, n_valid=len(blocks), with_health=True).resolve(),
        slab_wall, "fused_picks")
    del stack, bd
    t_design = design_t["s"]
    per_file = (wall - t_design) / len(paths)
    writes = picks_t["s"] + manifest_t["s"]
    say(f"campaign: run_campaign_batched at its defaults (batch 4, bucket pow2, conditioned "
        f"wire, engine='h5py' (the TDMS format reader), family 'mf', health, dispatch depth "
        f"{dispatch_depth_default()}), "
        f"interrogator 'silixa', {len(paths)} files of {nx} channels "
        f"({', '.join(str(ns) for _, ns in SLAB_FILES)} samples): wall {wall:.3f} s, of which "
        f"the bucket's detector {t_design:.3f} s (one bucket of {SLAB_BUCKET}; the slab "
        f"phase's design given, where it ran); pass "
        f"{per_file:.3f} s a file (wall less design, over {len(paths)} files; the slab phase's "
        f"timed pass is its yardstick); {slab_walls[1]} slabs, their resolve walls (each "
        f"slab's wait on its packed read, behind the pipelined dispatch; "
        f"das_slab_wall_seconds) sum {slab_walls[0]:.3f} s; the depth-2 pipeline (no host "
        f"sync inside a dispatch, set_sync_debug_mode): {pipeline}; two dispatches of the "
        f"campaign's first slab back to back: {ab}; picks "
        f"artifacts {picks_t['n']} writes {picks_t['s']:.4f} s, manifest {manifest_t['n']} "
        f"appends {manifest_t['s']:.4f} s, startup check {fsck_t['s']:.4f} s: the campaign's "
        f"own writes {writes:.4f} s = {100 * writes / (wall - t_design):.2f} % of the pass; "
        f"fused_picks launches {launches} over {attempts} attempts ({n_tiles} an "
        f"attempt), {reads} reads, {escalations} escalations; peak device memory "
        f"{peak / 2**30:.2f} GiB; downshift events {len(moves)}; every file done at "
        f"batched:4, {n_same} files' saved picks bitwise the slab phase's batched picks, "
        f"every injected call picked; resume {resume_wall:.3f} s: {len(paths)} skipped, 0 "
        f"streams; summarize_campaign {summary['n_done']} done; fsck_outdir clean; one slab "
        f"of the campaign's facade {slab_wall * 1e3:.1f} ms (runs "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls)}), device busy "
        f"{100 * sum(fams.values()) / (slab_wall * 1e3):.1f} %; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    shutil.rmtree(out, ignore_errors=True)
    return launches


#: the card-vs-CPU campaign files: 512 channels x 12000 samples, int32
#: (seeds), a float32 one with NaNs and a garbage file
CAMPAIGN_CPU_FILES = ((2040, 12000), (2041, 12000), (2042, 12000), (2043, 12000),
                      (2044, 12000))


def _compare_campaigns(label, card, cpu, cpu_det, blocks, scenes, records=True):
    """Two campaigns: with ``records``, file, status, rung and attempts
    equal record for record; the files done in both: picks equal up to
    rounding knife edges and every injected call picked. Returns the
    count of differing picks."""
    from das4whales_tpu_torch.utils.parity import envelopes, unexplained_differences
    from das4whales_tpu_torch.workflows.campaign import load_picks

    a = [(r.path, r.status, r.rung, r.attempts) for r in card.records]
    b = [(r.path, r.status, r.rung, r.attempts) for r in cpu.records]
    if records and a != b:
        fail(f"campaign_cpu_vs_card: {label}: records differ: {a} vs {b}")
    n_diff = 0
    for k, (ra, rb) in enumerate(zip(card.records, cpu.records)):
        if ra.status != "done" or rb.status != "done" or ra.path != rb.path:
            continue
        pa, pb = load_picks(ra.picks_file), load_picks(rb.picks_file)
        env = None
        for i, name in enumerate(pb):
            if np.array_equal(pa[name], pb[name]):
                continue
            with np.load(rb.picks_file) as z:
                thr = float(z["thresholds"][i])
            env = envelopes(cpu_det, blocks[ra.path]) if env is None else env
            bad = unexplained_differences(pa[name], pb[name], env[i], thr)
            if bad:
                fail(f"campaign_cpu_vs_card: {label}: file {k} template {name}: picks "
                     f"differ beyond rounding at {bad[:10]}")
            n_diff += len({tuple(p) for p in pa[name].T.tolist()}
                          ^ {tuple(p) for p in pb[name].T.tolist()})
        scene = scenes.get(ra.path)
        if scene is not None and _check_calls(scene, pa):
            fail(f"campaign_cpu_vs_card: {label}: file {k}: the injected call was missed")
    return n_diff


def _bank_split_campaigns(d, files, sel, meta, design) -> list:
    """A ``fin-variants`` batched campaign (batch 2) whose full-bank slab
    program always runs out of memory (:func:`_oom_full_bank`) must move
    ``batched:2 -> bank:2`` once and keep the healthy run's picks bit for
    bit, on the card and on the CPU. ``design`` is the bucket's fin
    design; the bank's stack is compiled into it. Returns notes."""
    import dataclasses

    from das4whales_tpu_torch.models.templates import resolve_bank
    from das4whales_tpu_torch.parallel.batch import BatchedMatchedFilterDetector
    from das4whales_tpu_torch.utils.checkpoint import save_design
    from das4whales_tpu_torch.workflows import campaign as cmod

    bank = resolve_bank("fin-variants")
    ns = design.trace_shape[1]
    bpath = save_design(str(d / "design_bank"), dataclasses.replace(
        design, templates=bank.compile(ns, meta.fs), template_names=bank.names,
        threshold_factors=bank.threshold_factors(), threshold_scope=bank.threshold_scope))
    kw = dict(metadata=meta, interrogator="silixa", design=bpath, templates=bank.name, batch=2)
    notes = []
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        healthy = cmod.run_campaign_batched(files, sel, str(d / f"bank_ok_{dev}"), device=dev,
                                            **kw)
        with _oom_full_bank(BatchedMatchedFilterDetector, len(bank)):
            split = cmod.run_campaign_batched(files, sel, str(d / f"bank_split_{dev}"),
                                              device=dev, **kw)
        got = [(r.status, r.rung) for r in split.records]
        moves = _downshifts(d / f"bank_split_{dev}")
        if ([(r.status, r.rung) for r in healthy.records] != [("done", "batched:2")] * len(files)
                or got != [("done", "bank:2")] * len(files) or moves != [("batched:2", "bank:2")]):
            fail(f"campaign_cpu_vs_card: bank split ({dev}): records {got}, downshifts {moves}; "
                 "expected every file done at bank:2 after one batched:2 -> bank:2")
        n_picks = 0
        for h, s_ in zip(healthy.records, split.records):
            a, b = cmod.load_picks(h.picks_file), cmod.load_picks(s_.picks_file)
            if set(a) != set(bank.names) or any(not np.array_equal(a[t], b[t]) for t in a):
                fail(f"campaign_cpu_vs_card: bank split ({dev}): {os.path.basename(h.path)}: "
                     "the bank:2 picks differ from the healthy run's")
            n_picks += sum(int(v.shape[1]) for v in b.values())
        notes.append(f"bank split ({dev}): fin-variants, the full-bank slab program refused: "
                     f"batched:2 -> bank:2, {len(files)} files done there, {n_picks} picks "
                     f"bitwise the healthy run's ({time.perf_counter() - t0:.1f} s)")
    return notes


def phase_campaign_cpu_vs_card():
    """Both campaign entries on the card against the CPU at 512 channels,
    then the resilience contract on the card: an oom that downshifts once,
    a corrupt file, a NaN file, a wedged dispatch under the watchdog, the
    spectro family on one slab, a design checkpoint, and the bank-split
    rung on the card and the CPU."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from das4whales_tpu_torch import faults
    from das4whales_tpu_torch.io.stream import stream_batched_slabs
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.models.spectro import FUSED_DEFAULT_BATCH
    from das4whales_tpu_torch.ops import fused_stft
    from das4whales_tpu_torch.parallel.batch import (BatchedMatchedFilterDetector,
                                                     batched_detector_for, trim_picks)
    from das4whales_tpu_torch.utils.checkpoint import save_design
    from das4whales_tpu_torch.workflows.planner import MatchedFilterProgram
    from das4whales_tpu_torch.workflows import campaign as cmod
    from das4whales_tpu_torch.workflows.spectrodetect import campaign_detector

    nx = 512
    sel = [0, nx, 1]
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    d = Path(tempfile.mkdtemp(prefix="campaign_cpu_files_", dir=root))
    notes = []
    t_phase = time.perf_counter()
    try:
        clean, scenes_l, _ = _write_files(d, CAMPAIGN_CPU_FILES, nx, n_calls=1)
        (d / "nan").mkdir()
        nan_path, _, _ = _write_files(d / "nan", ((2045, 12000),), nx, n_calls=1,
                                      float_file=_poison)
        (d / "bad.tdms").write_bytes(b"TDSm garbage, not a TDMS segment " * 32)
        meta = scenes_l[0].metadata
        scenes = dict(zip(clean, scenes_l))
        files = clean[:2] + [str(d / "bad.tdms")] + clean[2:3] + nan_path + clean[3:]
        design = MatchedFilterDetector(meta, sel, (nx, SLAB_BUCKET), device="cpu").design
        dpath = save_design(str(d / "design_16384"), design)
        cpu_det = MatchedFilterDetector.from_design(design, meta, device="cpu")
        blocks = {}
        for slab in stream_batched_slabs(clean, sel, meta, batch=1, bucket="pow2", as_numpy=True):
            blocks[slab.paths[0]] = slab.stack[0]
        kw = dict(metadata=meta, interrogator="silixa", design=dpath)

        def run(entry, out, **extra):
            return entry(files if "files" not in extra else extra.pop("files"), sel,
                         str(d / out), **kw, **extra)

        # 1. both entries, card against CPU, record for record
        res = {}
        pf_design = MatchedFilterDetector(meta, sel, (nx, 12000), device="cpu").design
        for dev in ("cuda", "cpu"):
            # on the card, no pipelined dispatch may make the host wait
            with _no_host_sync(BatchedMatchedFilterDetector, "dispatch_batch") as g_b, \
                    _no_host_sync(MatchedFilterProgram, "dispatch") as g_f:
                res[("batched", dev)] = run(cmod.run_campaign_batched, f"b_{dev}", device=dev)
                res[("file", dev)] = cmod.run_campaign(
                    files, sel, str(d / f"f_{dev}"), metadata=meta, interrogator="silixa",
                    detector=MatchedFilterDetector.from_design(pf_design, meta, device=dev))
            if dev != "cuda":
                continue
            if g_b["syncs"] or g_f["syncs"] or not g_b["n"] or not g_f["n"]:
                fail(f"campaign_cpu_vs_card: pipelined dispatches on the card: batched "
                     f"{g_b['n']}, per-file {g_f['n']}; host syncs inside them "
                     f"{g_b['syncs'] + g_f['syncs']}")
            notes.append(f"pipelined dispatches on the card without a host sync: {g_b['n']} "
                         f"batched, {g_f['n']} per-file")
        want = ["done", "done", "failed", "done", "quarantined", "done", "done"]
        for route in ("batched", "file"):
            got = [r.status for r in res[(route, "cuda")].records]
            if got != want:
                fail(f"campaign_cpu_vs_card: {route}: statuses {got}, expected {want}")
            det_for = cpu_det if route == "batched" else MatchedFilterDetector.from_design(
                pf_design, meta, device="cpu")
            blk = blocks if route == "batched" else {
                p: b[:, :12000] for p, b in blocks.items()}
            n_diff = _compare_campaigns(route, res[(route, "cuda")], res[(route, "cpu")],
                                        det_for, blk, scenes)
            notes.append(f"run_campaign{'_batched' if route == 'batched' else ''} card vs "
                         f"CPU: records equal (file, status, rung, attempts: "
                         f"{[(r.status, r.rung) for r in res[(route, 'cuda')].records]}), "
                         f"{n_diff} differing picks, all on knife edges")
        # 2. the chaos plan: an oom at batched:4 (fits from batched:2), a
        # corrupt file, a NaN file — serial mode (each file its own program,
        # so the picks are bitwise at every B) and the default batched mode
        name = os.path.basename
        pinned = {
            name(clean[0]): faults.FaultSpec("oom", "dispatch", 10**9, ("batched", 2)),
            name(clean[2]): faults.FaultSpec("truncated", "read", 10**9),
            name(clean[4]): faults.FaultSpec("nan", "read", 10**9),
        }
        for mode, serial in (("serial", True), ("batched", False)):
            free = cmod.run_campaign_batched(clean, sel, str(d / f"free_{mode}"), serial=serial,
                                             **kw)
            plan = faults.FaultPlan(7, rate=0.0, pinned=pinned)
            hurt = cmod.run_campaign_batched(clean, sel, str(d / f"chaos_{mode}"),
                                             serial=serial, fault_plan=plan, **kw)
            got = [(r.status, r.rung) for r in hurt.records]
            want_c = [("done", "batched:2"), ("done", "batched:2"), ("failed", ""),
                      ("done", "batched:2"), ("quarantined", "batched:2")]
            moves = _downshifts(d / f"chaos_{mode}")
            if got != want_c or moves != [("batched:4", "batched:2")]:
                fail(f"campaign_cpu_vs_card: chaos ({mode}): records {got}, downshifts "
                     f"{moves}; expected {want_c} and one batched:4 -> batched:2")
            same = all(
                np.array_equal(cmod.load_picks(h.picks_file)[t], cmod.load_picks(f.picks_file)[t])
                for h, f in zip(hurt.records, free.records) if h.status == "done"
                for t in cmod.load_picks(f.picks_file))
            if serial and not same:
                fail("campaign_cpu_vs_card: chaos (serial): the downshifted picks differ "
                     "from the fault-free run")
            if not same:
                _compare_campaigns(f"chaos ({mode}) vs fault-free", hurt, free, cpu_det,
                                   blocks, scenes, records=False)
            notes.append(f"chaos ({mode} mode): one oom at batched:4 -> one downshift to "
                         f"batched:2, a corrupt file failed, a NaN file quarantined; picks "
                         f"{'bitwise equal to' if same else 'within knife edges of'} the "
                         f"fault-free run")
        # 3. the watchdog: a wedged dispatch times out that file only
        plan = faults.FaultPlan(0, rate=0.0, hang_s=4.0, pinned={
            name(clean[1]): faults.FaultSpec("hang_dispatch", "dispatch", 10**9)})
        t0 = time.perf_counter()
        hung = cmod.run_campaign_batched(clean[:4], sel, str(d / "hang"), fault_plan=plan,
                                         dispatch_deadline_s=2.0, **kw)
        got = [(r.status, r.rung) for r in hung.records]
        if got != [("done", "file"), ("timeout", "file"), ("done", "file"), ("done", "file")]:
            fail(f"campaign_cpu_vs_card: watchdog: records {got}; the wedged slab's files "
                 "run one by one at the per-file rung, the wedged one times out")
        notes.append(f"watchdog (dispatch_deadline_s 2.0, a 4.0 s wedge): "
                     f"{[(r.status, r.rung) for r in hung.records]} in "
                     f"{time.perf_counter() - t0:.1f} s")
        # 4. the spectro family on one slab: fused_stft launches (each held
        # against its plain version on the campaign's own inputs), the
        # facade's picks
        sfiles = clean[:2]
        ad = campaign_detector(meta, sel, (nx, 12000))
        rows = len(sfiles) * nx              # the facade's [n * C, T] correlogram input
        chunk = ad.det.batch_channels or FUSED_DEFAULT_BATCH
        want = len(ad.det.kernels) * -(-rows // chunk)
        zero_launches()                      # the spectro campaign's main path starts here
        with _capture(fused_stft, "stft_power_cuda") as calls:
            sres = cmod.run_campaign_batched(sfiles, sel, str(d / "spectro"), family="spectro",
                                             batch=2, metadata=meta, interrogator="silixa")
        stft_launches = read_launches()["fused_stft"]
        if [(r.status, r.rung) for r in sres.records] != [("done", "batched:2")] * 2:
            fail(f"campaign_cpu_vs_card: spectro: {[(r.status, r.rung) for r in sres.records]}")
        if stft_launches != want:
            fail(f"campaign_cpu_vs_card: the spectro campaign launched fused_stft "
                 f"{stft_launches} times, expected {want} ({len(ad.det.kernels)} hat kernels x "
                 f"{-(-rows // chunk)} chunks of {rows} channels)")
        shape = (min(rows, chunk), 12000)
        stft_err, rel, (nfft, hop) = _stft_at_main_path("campaign_cpu_vs_card: spectro", calls,
                                                        shape)
        del calls
        bd = batched_detector_for(ad)
        slab = next(stream_batched_slabs(sfiles, sel, meta, batch=2, bucket="exact"))
        facade = bd.detect_batch(slab.stack, n_real=slab.n_real, n_valid=slab.n_valid)
        for k, rec in enumerate(sres.records):
            got = cmod.load_picks(rec.picks_file)
            ref = trim_picks(facade[k][0], slab.n_real[k])
            for t in ref:
                if not np.array_equal(got[t], ref[t]):
                    fail(f"campaign_cpu_vs_card: spectro: file {k} kernel {t}: the "
                         "campaign's picks differ from the facade's")
        del slab
        notes.append(f"spectro campaign: 2 files done at batched:2, {stft_launches} fused_stft "
                     f"launches (as expected), fused_stft within {STFT_REL_TOL} * max of its "
                     f"plain version at the campaign's first and last launch {shape} nfft "
                     f"{nfft} hop {hop} (relative max error {rel:.2e}), picks equal to "
                     f"BatchedSpectroDetector's")
        # 5. a design checkpoint saved by the port and loaded again: the
        # same files (so the same slabs) as the card's batched run of 1.
        det = MatchedFilterDetector.from_design(design, meta)
        dpath2 = save_design(str(d / "design_again"), det.design)
        again = cmod.run_campaign_batched(files, sel, str(d / "design_again_out"),
                                          metadata=meta, interrogator="silixa", design=dpath2)
        base = res[("batched", "cuda")]
        if [(r.status, r.rung) for r in again.records] != [(r.status, r.rung) for r in base.records]:
            fail(f"campaign_cpu_vs_card: checkpoint run: {[r.status for r in again.records]}")
        for r, b_ in zip(again.records, base.records):
            if r.status != "done":
                continue
            a, b = cmod.load_picks(r.picks_file), cmod.load_picks(b_.picks_file)
            if any(not np.array_equal(a[t], b[t]) for t in b):
                fail("campaign_cpu_vs_card: the reloaded design's picks differ")
        notes.append("a design saved by the port and loaded again: bitwise the same picks")
        # 6. the bank-split rung, on the card and on the CPU
        # two files, one slab of 2: every check of the split holds on one slab
        notes += _bank_split_campaigns(d, clean[:2], sel, meta, design)
        torch.cuda.synchronize()
        say(f"campaign_cpu_vs_card: {nx} channels x 12000 samples, 5 int32 files, a corrupt and "
            f"a NaN file, batch 4, pow2 bucket {SLAB_BUCKET}: {'; '.join(notes)}; phase "
            f"{time.perf_counter() - t_phase:.1f} s")
        return stft_launches, stft_err
    finally:
        shutil.rmtree(d, ignore_errors=True)


#: main_gabordetect.py's thresholds (set on OOI data)
GABOR_THRESHOLDS = (9100.0, 150.0)
#: thresholds that keep every injected call of the synthetic scene in a JAX
#: CPU run (``scripts/gabor_threshold_check.py``, 2205 x 12000, which keeps
#: them at 9100 / 150 too); the gabor phase runs them only where the
#: reference's miss a call on the card
GABOR_FALLBACK_THRESHOLDS = (2000.0, 50.0)
#: the "conv" engine's score against the "fft" engine's, of max|score|
#: (10201-tap direct sums against an FFT product)
GABOR_ENGINE_REL = 1e-5
#: card against CPU: score and correlograms within this of max|cpu|
GABOR_CARD_REL = 1e-4
GABOR_BATCH = 4
#: the Gabor campaign's files (of the slab phase's four 12000-sample ones;
#: one, not two, for the run's time limit: a partial slab either way)
GABOR_CAMPAIGN_FILES = 1
GABOR_CPU_FILES = ((2050, 12000), (2051, 12000), (2052, 12000))


def _gabor_adapter(meta, nx, ns, design, **kw):
    """``gabordetect.campaign_detector`` on ``design`` (the campaign's
    adapter without a second f-k design)."""
    from das4whales_tpu_torch.workflows.gabordetect import campaign_detector

    return campaign_detector(meta, [0, nx, 1], (nx, ns), design=design, **kw)


def _gabor_batched_peak(meta, nx, x, notes):
    """``BatchedGaborDetector`` (batched mode) on a [4, nx, 16384] slab of
    the canonical block zero-padded to the slab bucket: the peak device
    memory, or, where the card runs out, the same at B = 2 and 1 (the
    ladder's batched rungs). Appends to ``notes``; returns the B that
    served and its peak in bytes."""
    import torch

    from das4whales_tpu_torch import faults
    from das4whales_tpu_torch.eval import GaborEvalAdapter
    from das4whales_tpu_torch.models.gabor import GaborDetector
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.parallel.batch import BatchedGaborDetector

    design16 = _SLAB_DESIGN.get("design")
    if design16 is None:
        t0 = time.perf_counter()
        design16 = MatchedFilterDetector(meta, [0, nx, 1], (nx, SLAB_BUCKET), templates="fin",
                                         device="cpu").design
        notes.append(f"designed the {SLAB_BUCKET} bucket here ({time.perf_counter() - t0:.1f} s)")
    ns = x.shape[-1]
    bd = BatchedGaborDetector(GaborEvalAdapter(
        MatchedFilterDetector.from_design(design16, meta, wire="conditioned"),
        GaborDetector(meta, [0, nx, 1], gabor_engine="fft")), serial=False)
    for b in (GABOR_BATCH, 2, 1):
        stack = torch.zeros((b, nx, SLAB_BUCKET), device="cuda")
        stack[:, :, :ns] = x
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            out = bd.detect_batch(stack)
        except Exception as exc:  # noqa: BLE001 — an out-of-memory moves to a smaller B
            if faults.classify_failure(exc) != "resource":
                raise
            del stack
            torch.cuda.empty_cache()
            notes.append(f"[{b}, {nx}, {SLAB_BUCKET}] ran out of memory ({type(exc).__name__})")
            continue
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        if len(out) != b or any(not p[k].shape[1] for p, _ in out for k in p):
            fail(f"gabor: the batched facade at [{b}, {nx}, {SLAB_BUCKET}] returned "
                 f"{len(out)} entries or an empty pick set")
        notes.append(f"BatchedGaborDetector (batched mode) at [{b}, {nx}, {SLAB_BUCKET}]: "
                     f"{wall * 1e3:.1f} ms (first call), peak device memory "
                     f"{peak / 2**30:.2f} GiB; served at batched:{b}")
        del stack, out
        torch.cuda.empty_cache()
        return b, peak
    fail(f"gabor: the batched facade ran out of memory at every B down to 1")


def _gabor_campaign(meta, nx, design, launches_before, notes):
    """``run_campaign_batched(family="gabor", batch=4)`` over
    ``GABOR_CAMPAIGN_FILES`` of the slab phase's four 12000-sample TDMS
    files (one exact bucket, a partial slab of [4, nx, 12000])
    on ``design``: every file done, the rung that served and any downshift
    reported, every injected call picked, two ``fused_picks`` launches a
    file (+1 a note that escalated). Returns the launches."""
    import shutil

    import torch

    from das4whales_tpu_torch.workflows import campaign as cmod

    shared = slab_files()
    # GABOR_CAMPAIGN_FILES of the four files, a partial slab at batch 4 (a
    # cut for the run's time limit: the reads are most of the campaign's wall)
    files = [p for p, (_, ns) in zip(shared["paths"], SLAB_FILES)
             if ns == CANONICAL[1]][:GABOR_CAMPAIGN_FILES]
    scenes = dict(zip(shared["paths"], shared["scenes"]))
    out = shared["dir"] / "gabor_out"
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _timing(cmod, "family_detector", keep=True) as built:
        t0 = time.perf_counter()
        res = cmod.run_campaign_batched(files, [0, nx, 1], str(out), metadata=meta,
                                        interrogator="silixa", batch=GABOR_BATCH,
                                        family="gabor", design=design, gabor_engine="fft")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = read_launches()["fused_picks"] - launches_before
    rungs = sorted({r.rung for r in res.records})
    if [r.status for r in res.records] != ["done"] * len(files) or len(rungs) != 1:
        fail(f"gabor: campaign records {[(r.status, r.rung) for r in res.records]}")
    if built["n"] != 1:
        fail(f"gabor: campaign built {built['n']} detectors for one bucket")
    esc = built["out"][0].det.escalations
    if launches != 2 * len(files) + esc:
        fail(f"gabor: campaign launched fused_picks {launches} times for {len(files)} files "
             f"({esc} escalations)")
    for rec in res.records:
        misses = _check_calls(scenes[rec.path], cmod.load_picks(rec.picks_file))
        if misses:
            fail(f"gabor: campaign: {rec.path}: injected calls missed {misses}")
    moves = _downshifts(out)
    notes.append(f"run_campaign_batched(family='gabor', batch {GABOR_BATCH}) over {len(files)} "
                 f"canonical TDMS files (one exact bucket [{GABOR_BATCH}, {nx}, "
                 f"{CANONICAL[1]}]): {wall:.1f} s, every file done at {rungs[0]}, downshifts "
                 f"{moves or 'none'}, {launches} fused_picks launches, every injected call "
                 f"picked, peak device memory {peak / 2**30:.2f} GiB")
    shutil.rmtree(out, ignore_errors=True)
    return launches


def phase_gabor(scene=None, raw=None, design=None):
    """The Gabor family at main_gabordetect.py's settings on the canonical
    block, conditioned on the host, through ``campaign_detector``'s adapter
    on the ``detect`` phase's design: timed runs, stage walls, the pick kernel's
    launches and its bitwise check at the route's first and last launch,
    the "conv" engine once, the batched facade's peak at the slab bucket
    and a Gabor campaign over the slab files."""
    import torch

    from das4whales_tpu_torch.ops import fused_picks

    if design is None:
        scene, raw, design = _canonical_inputs()
    t_phase = time.perf_counter()
    nx, ns = raw.shape
    meta = scene.metadata
    t0 = time.perf_counter()
    x = torch.as_tensor(_condition_on_host(raw, meta.scale_factor)).to("cuda")
    t_cond = time.perf_counter() - t0
    thr1, thr2 = GABOR_THRESHOLDS
    adapter = _gabor_adapter(meta, nx, ns, design, threshold1=thr1, threshold2=thr2,
                             gabor_engine="fft")
    det = adapter.det
    n_notes = len(det.notes)
    if (det.design.bin_factor, det.design.gabor_up.shape, det.gabor_engine) != (
            0.1, (101, 101), "fft"):
        fail(f"gabor: the detector resolved bin {det.design.bin_factor}, kernel "
             f"{det.design.gabor_up.shape}, engine {det.gabor_engine!r}")
    adapter(x)                                # warm-up: cuFFT plans, kernel load
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()                           # the main path's runs start here
    det.syncs = det.escalations = 0
    walls, stages, deltas, res = _timed_runs(
        lambda hook: adapter(x, stage_hook=hook),
        {"launches": lambda: fused_picks.launches, "syncs": lambda: det.syncs,
         "escalations": lambda: det.escalations})
    launches = read_launches()["fused_picks"]
    peak = torch.cuda.max_memory_allocated()
    for k, d in enumerate(deltas):
        if d["launches"] != n_notes + d["escalations"]:
            fail(f"gabor: run {k} launched the pick kernel {d['launches']} times with "
                 f"{d['escalations']} escalations, expected one a note and attempt")
        # the max, then per note a saturation check and a packed fetch (+1 an
        # escalation, +1 a capacity overflow)
        if not 1 + 2 * n_notes + d["escalations"] <= d["syncs"] <= 1 + 3 * n_notes + d["escalations"]:
            fail(f"gabor: run {k} made {d['syncs']} device->host reads")
    for name, p in res.picks.items():
        if p.ndim != 2 or p.shape[0] != 2 or not p.shape[1]:
            fail(f"gabor: note {name} returned picks of shape {p.shape}")
        if not (np.all((p[0] >= 0) & (p[0] < nx)) and np.all((p[1] >= 0) & (p[1] < ns))):
            fail(f"gabor: note {name} has picks outside the block")
    if not all(np.isfinite(t) and t > 0 for t in res.thresholds.values()):
        fail(f"gabor: thresholds {res.thresholds}")
    notes = []
    misses = _check_calls(scene, res.picks)
    if misses:
        fb1, fb2 = GABOR_FALLBACK_THRESHOLDS
        notes.append(f"the reference's thresholds {thr1:g} / {thr2:g} MISS injected calls "
                     f"{misses} on this synthetic scene; rerun at {fb1:g} / {fb2:g} (the "
                     "thresholds a JAX CPU run keeps every call at, "
                     "scripts/gabor_threshold_check.py)")
        fb = _gabor_adapter(meta, nx, ns, design, threshold1=fb1, threshold2=fb2,
                            gabor_engine="fft")
        miss_fb = _check_calls(scene, fb(x).picks)
        if miss_fb:
            fail(f"gabor: injected calls missed at the fallback thresholds too: {miss_fb}")
        del fb
    else:
        notes.append(f"the reference's thresholds {thr1:g} / {thr2:g} keep every injected call")
    wall = statistics.median(walls)
    fams = _profile("GaborEvalAdapter call", lambda: adapter(x), wall, "fused_picks")
    mask_frac = float(det(adapter.prefilter.filter_block(x))["mask"].float().mean())
    with _capture(fused_picks, "picks_cuda") as calls:
        adapter(x)
        torch.cuda.synchronize()
    err, pick_notes = _picks_at_main_path("gabor", calls, {"first": nx, "last": nx})
    del calls

    # the "conv" engine once, on the same filtered block
    from das4whales_tpu_torch.models.gabor import GaborDetector

    trf = adapter.prefilter.filter_block(x)
    conv = GaborDetector(meta, [0, nx, 1], threshold1=thr1, threshold2=thr2, gabor_engine="conv")
    eng_ms = {}
    score = {}
    for label, d in (("fft", det), ("conv", conv), ("conv", conv), ("fft", det)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        score[label] = d.correlograms(trf)[0]
        torch.cuda.synchronize()
        eng_ms.setdefault(label, []).append((time.perf_counter() - t0) * 1e3)
    e = float((score["conv"] - score["fft"]).abs().max())
    scale = float(score["fft"].abs().max())
    if not e <= GABOR_ENGINE_REL * scale:
        fail(f"gabor: the conv engine's score is {e:.3e} from the fft engine's (limit "
             f"{GABOR_ENGINE_REL} * {scale:.3e})")
    del trf, score, conv
    torch.cuda.empty_cache()

    b_served, b_peak = _gabor_batched_peak(meta, nx, x, notes)
    del x, adapter
    torch.cuda.empty_cache()
    campaign_launches = _gabor_campaign(meta, nx, design, read_launches()["fused_picks"], notes)
    say(f"gabor: {nx}x{ns} conditioned float32, gabordetect.campaign_detector on the detect "
        f"design (main_gabordetect.py: c0 1500 m/s, bin {det.design.bin_factor}, ksize 100 -> "
        f"101x101, thresholds {thr1:g} / {thr2:g}, notes {'/'.join(det.notes)}, engine "
        f"{det.gabor_engine!r}); median wall {wall * 1e3:.1f} ms (runs "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms); stage walls (median, CUDA events) "
        f"{json.dumps(_median_stages(stages))} ms; per run (fused_picks launches, syncs, "
        f"escalations) {[tuple(d.values()) for d in deltas]}; picks "
        f"{json.dumps({k: int(v.shape[1]) for k, v in res.picks.items()})}; thresholds "
        f"{json.dumps({k: round(v, 6) for k, v in res.thresholds.items()})}; binned mask "
        f"{100 * mask_frac:.2f} % set; peak device memory {peak / 2**30:.2f} GiB; host "
        f"conditioning {t_cond:.1f} s; fused_picks bitwise its plain version at the route's "
        f"first and last launch: {'; '.join(pick_notes)}")
    say(f"gabor: engine 'conv' (F.conv2d, TF32 off) score within {e / scale:.3e} * max of "
        f"'fft''s (limit {GABOR_ENGINE_REL}); correlograms stage (mask + masked MF) wall "
        f"fft {', '.join(f'{v:.1f}' for v in eng_ms['fft'])} ms, conv "
        f"{', '.join(f'{v:.1f}' for v in eng_ms['conv'])} ms (in turns fft, conv, conv, fft)")
    say(f"gabor: {'; '.join(notes)}; phase {time.perf_counter() - t_phase:.1f} s")
    return launches, campaign_launches, err, {"wall_ms": wall * 1e3, "peak": peak,
                                              "batched": (b_served, b_peak), "fams": fams}


def _gabor_knife_edges(label, score_ref, thr, got, rel, where="gabor_cpu_vs_card"):
    """Pixels where the boolean image ``got`` differs from ``score_ref > thr``,
    each required to lie within ``rel * max|score_ref|`` of ``thr`` (a
    rounding knife edge). Returns the count."""
    diff = (score_ref > thr) != got
    edge = (score_ref - thr).abs() <= rel * float(score_ref.abs().max())
    bad = int((diff & ~edge).sum())
    if bad:
        fail(f"{where}: {label}: {bad} pixels flipped off the knife edge")
    return int(diff.sum())


def _manifest_records(outdir) -> list:
    """A campaign's manifest lines without wall times, span ids, pick
    counts and the directories of paths."""
    from das4whales_tpu_torch.utils.artifacts import read_records

    out = []
    for rec in read_records(str(outdir / "manifest.jsonl")):
        rec = {k: v for k, v in rec.items() if k not in ("wall_s", "span_id", "n_picks")}
        for k in ("path", "picks_file"):
            if rec.get(k):
                rec[k] = os.path.basename(rec[k])
        out.append(rec)
    return out


def phase_gabor_cpu_vs_card():
    """The Gabor family on the card against ``device="cpu"`` at 512 x 12000
    on one design and one set of notes: score and correlograms within
    1e-4 * max|cpu|, binary image and mask equal up to counted knife
    edges, picks equal up to knife edges; then ``run_campaign_batched``
    (batch 2) and ``run_campaign`` with ``family="gabor"`` over three TDMS
    files on both devices, manifests equal record by record."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from das4whales_tpu_torch import convert
    from das4whales_tpu_torch.eval import GaborEvalAdapter
    from das4whales_tpu_torch.io.synth import synthesize_scene, to_raw_counts
    from das4whales_tpu_torch.io.stream import stream_batched_slabs
    from das4whales_tpu_torch.models import gabor as gmod
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.ops import image as img_ops
    from das4whales_tpu_torch.ops import spectral
    from das4whales_tpu_torch.utils.parity import unexplained_differences
    from das4whales_tpu_torch.workflows import campaign as cmod
    from das4whales_tpu_torch.workflows.gabordetect import campaign_detector

    t_phase = time.perf_counter()
    nx, ns = 512, CANONICAL[1]
    sel = [0, nx, 1]
    scene = _scene(nx, ns, n_calls=2, seed=SEED + 3)
    meta = scene.metadata
    cond = _condition_on_host(to_raw_counts(synthesize_scene(scene), meta), meta.scale_factor)
    card = campaign_detector(meta, sel, (nx, ns), gabor_engine="fft")
    cpu = GaborEvalAdapter(
        MatchedFilterDetector.from_design(card.prefilter.design, meta, device="cpu"),
        convert.gabor_detector_from_jax(convert.gabor_detector_to_arrays(card.det), meta,
                                        gabor_engine="fft", device="cpu"))
    out = {}
    for dev, ad in (("cuda", card), ("cpu", cpu)):
        r = ad.det(ad.prefilter.filter_block(cond))
        out[dev] = {k: (v.cpu() if isinstance(v, torch.Tensor) else
                        {n: t.cpu() for n, t in v.items()} if k == "correlograms" else v)
                    for k, v in r.items()}
    g, c = out["cuda"], out["cpu"]
    e = float((g["score"] - c["score"]).abs().max()) / float(c["score"].abs().max())
    if not e <= GABOR_CARD_REL:
        fail(f"gabor_cpu_vs_card: score {e:.3e} * max apart (limit {GABOR_CARD_REL})")
    d = cpu.det.design
    n_bin = _gabor_knife_edges("binary", c["score"], d.threshold1, g["score"] > d.threshold1,
                               GABOR_CARD_REL)
    # the mask: the CPU's second score of the CARD's binary image, so a binary
    # knife edge cannot hide a mask fault
    up, down = cpu.det._kernels
    s2 = gmod._gabor_score((g["score"] > d.threshold1).float(), up, down)
    n_mask = _gabor_knife_edges("mask", s2, d.threshold2, g["mask"], GABOR_CARD_REL)
    ref_corr = c["correlograms"]
    if not torch.equal(g["mask"], c["mask"]):
        # the CPU's masked matched filter on the card's mask: the correlograms
        # the card's mask gives, on the CPU
        trf = cpu.prefilter.filter_block(cond)
        masked = img_ops.apply_smooth_mask(trf, img_ops.resize_linear(
            g["mask"].float(), tuple(trf.shape), antialias=False))
        ref_corr = {n: gmod.masked_matched_filter(masked, note)
                    for n, note in cpu.det.notes.items()}
    worst, n_diff = e, 0
    picks_ref, _, thresholds = cpu.det.picks_from_correlograms(ref_corr)
    for name, rc in ref_corr.items():
        ec = float((g["correlograms"][name] - rc).abs().max()) / float(rc.abs().max())
        worst = max(worst, ec)
        if not ec <= GABOR_CARD_REL:
            fail(f"gabor_cpu_vs_card: note {name} correlograms {ec:.3e} * max apart")
        if not np.isclose(g["thresholds"][name], thresholds[name], rtol=1e-5, atol=0):
            fail(f"gabor_cpu_vs_card: note {name} threshold card {g['thresholds'][name]} vs "
                 f"cpu {thresholds[name]}")
        env = spectral.envelope_sqrt(rc).numpy()
        a, b = g["picks"][name], picks_ref[name]
        bad = unexplained_differences(a, b, env, thresholds[name])
        if bad:
            fail(f"gabor_cpu_vs_card: note {name}: picks differ beyond rounding at {bad[:10]}")
        n_diff += len({tuple(p) for p in a.T.tolist()} ^ {tuple(p) for p in b.T.tolist()})
    if _check_calls(scene, card(cond).picks):
        fail("gabor_cpu_vs_card: an injected call was not picked on the card")

    # both campaign entries, card against CPU, on one design
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    dd = Path(tempfile.mkdtemp(prefix="gabor_cpu_files_", dir=root))
    try:
        files, scenes_l, _ = _write_files(dd, GABOR_CPU_FILES, nx, n_calls=2)
        scenes = dict(zip(files, scenes_l))
        blocks = {}
        for slab in stream_batched_slabs(files, sel, meta, batch=1, bucket="exact",
                                         as_numpy=True):
            blocks[slab.paths[0]] = slab.stack[0]
        kw = dict(metadata=meta, interrogator="silixa", family="gabor",
                  design=card.prefilter.design, gabor_engine="fft")
        res = {}
        for entry, extra in ((cmod.run_campaign_batched, dict(batch=2)), (cmod.run_campaign, {})):
            for dev in ("cuda", "cpu"):
                res[(entry.__name__, dev)] = entry(files, sel, str(dd / f"{entry.__name__}_{dev}"),
                                                   device=dev, **kw, **extra)
        camp_notes = []
        for name in ("run_campaign_batched", "run_campaign"):
            ca, cb = res[(name, "cuda")], res[(name, "cpu")]
            ra = [(Path(r.path).name, r.status, r.rung, r.family, r.attempts) for r in ca.records]
            want_rung = "batched:2" if name == "run_campaign_batched" else "file"
            if {(r[1], r[2], r[3]) for r in ra} != {("done", want_rung, "gabor")}:
                fail(f"gabor_cpu_vs_card: {name}: records on the card {ra}")
            # the manifests record by record, less what a run's clock and
            # directory give and the pick counts (compared as pick sets below)
            ma, mb = (_manifest_records(dd / f"{name}_{dev}") for dev in ("cuda", "cpu"))
            if ma != mb:
                fail(f"gabor_cpu_vs_card: {name}: manifests differ: {ma} vs {mb}")
            n_camp = 0
            for x, y in zip(ca.records, cb.records):
                pa, pb = cmod.load_picks(x.picks_file), cmod.load_picks(y.picks_file)
                if _check_calls(scenes[x.path], pa):
                    fail(f"gabor_cpu_vs_card: {name}: {x.path}: an injected call was missed")
                if all(np.array_equal(pa[k], pb[k]) for k in pb):
                    continue
                corr = cpu.det.correlograms(cpu.prefilter.filter_block(blocks[x.path]))[3]
                with np.load(y.picks_file) as z:
                    thr = dict(zip([str(t) for t in z["template_names"]], z["thresholds"].tolist()))
                for k in pb:
                    env = spectral.envelope_sqrt(corr[k]).numpy()
                    bad = unexplained_differences(pa[k], pb[k], env, thr[k])
                    if bad:
                        fail(f"gabor_cpu_vs_card: {name}: {x.path} note {k}: picks differ "
                             f"beyond rounding at {bad[:10]}")
                    n_camp += len({tuple(p) for p in pa[k].T.tolist()}
                                  ^ {tuple(p) for p in pb[k].T.tolist()})
            camp_notes.append(f"{name}: {len(ra)} files done at {want_rung} on both, manifests "
                              f"equal record by record, {n_camp} picks differing (knife edges)")
    finally:
        shutil.rmtree(dd, ignore_errors=True)
    say(f"gabor_cpu_vs_card: {nx}x{ns}, one design and one set of notes: score and "
        f"correlograms within {GABOR_CARD_REL} * max|cpu| (measured max relative error "
        f"{worst:.3e}), {n_bin} binary and {n_mask} mask pixels flipped, all on knife edges; "
        f"picks {json.dumps({k: int(v.shape[1]) for k, v in g['picks'].items()})} on the card, "
        f"{n_diff} differing, all on knife edges; {'; '.join(camp_notes)}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")


#: the learned family's card against CPU: scores within this (absolute;
#: sigmoid scores lie in [0, 1]), picks equal up to knife edges within it
LEARNED_CARD_ABS = 1e-5
#: the one-program sweep against the tiled view and the batched facade on
#: the card: scores within this (cuDNN may pick another algorithm for
#: another batch size)
LEARNED_CHUNK_ABS = 1e-5
#: the CPU side of the learned campaigns reads every 40th channel (552 of
#: 22050): scores are per channel, so those rows' picks are the card's
LEARNED_CPU_STRIDE = 40
#: fit on the card against fit on the CPU: each epoch's mean loss within
#: this, relative
LEARNED_FIT_REL = 1e-3
LEARNED_BATCH = 4
#: the per-file learned campaign's files (the batched one takes all four;
#: one, not two, for the run's time limit)
LEARNED_FILE_CAMPAIGN_FILES = 1
#: the CNN's operations a window (multiply-adds as 2): conv0 16x4 outputs
#: x 16 channels x 9 taps, conv1 8x2 outputs x 32 channels x 9 x 16 taps
LEARNED_CONV_OPS = 2 * (16 * 4 * 16 * 9 + 8 * 2 * 32 * 9 * 16)


def _learned_rows(scene, nx: int) -> list:
    """The channels within 8 of each injected call's nearest channel."""
    return sorted({min(nx - 1, max(0, int(round(c.x0_m / scene.dx)) + d))
                   for c in scene.calls for d in range(-8, 9)})


def _learned_knife(label, a, b, scores, centers, thr, tol=LEARNED_CARD_ABS) -> int:
    """Picks ``a`` and ``b`` equal up to knife edges of ``scores``; returns
    the count of differing picks."""
    from das4whales_tpu_torch.utils.parity import unexplained_learned_differences

    bad = unexplained_learned_differences(a, b, scores, centers, thr, tol)
    if bad:
        fail(f"{label}: picks differ beyond rounding at {bad[:10]}")
    return len({tuple(p) for p in np.asarray(a).T.tolist()}
               ^ {tuple(p) for p in np.asarray(b).T.tolist()})


def _learned_facade(det, x, notes):
    """``BatchedLearnedDetector`` on a [4, nx, ns] slab of the canonical
    block rolled along the channels (four distinct files), serial and
    batched, against the per-file call on each file: serial picks bitwise,
    batched scores within ``LEARNED_CHUNK_ABS`` and picks up to knife
    edges; the peak of each mode, one ``fused_stft`` launch a slab
    (batched) or a file (serial), the kernel held against its plain
    version at the batched slab's launch. Returns ``(launches, err)``."""
    import torch

    from das4whales_tpu_torch.ops import fused_stft
    from das4whales_tpu_torch.parallel.batch import LEARNED_BATCH_ROWS, batched_detector_for

    nx, ns = x.shape
    shifts = [k * nx // LEARNED_BATCH for k in range(LEARNED_BATCH)]
    stack = torch.stack([x.roll(sh, 0) for sh in shifts])
    refs = [det(stack[b]) for b in range(LEARNED_BATCH)]
    out = {}
    for serial in (True, False):
        bd = batched_detector_for(det, serial=serial, trace_shape=(nx, ns))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        det.syncs = 0
        t0 = time.perf_counter()
        res = bd.detect_batch(stack)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_launches()
        want = LEARNED_BATCH if serial else 1
        if got != {"fused_picks": 0, "fused_stft": want} or det.syncs != 1:
            fail(f"learned: the {'serial' if serial else 'batched'} facade launched {got} and "
                 f"read {det.syncs} times, expected {want} fused_stft launches and one read")
        out[serial] = (res, wall, torch.cuda.max_memory_allocated(), got["fused_stft"])
    n_diff, worst = 0, 0.0
    slab_scores = bd._fetch(bd._heavy(stack))      # the batched heavy stage's scores
    for b, ref in enumerate(refs):
        for k in ref.picks:
            if not np.array_equal(out[True][0][b][0][k], ref.picks[k]):
                fail(f"learned: the serial facade's picks of file {b} differ from the per-file "
                     "call's")
        worst = max(worst, float(np.abs(slab_scores[b] - ref.scores).max()))
        n_diff += _learned_knife("learned: batched facade", ref.picks["CALL"],
                                 out[False][0][b][0]["CALL"], ref.scores, ref.centers,
                                 ref.thresholds["CALL"], LEARNED_CHUNK_ABS)
    walls = {k: v[1:] for k, v in out.items()}       # (wall, peak, launches) by mode
    del out, refs, slab_scores
    torch.cuda.empty_cache()
    with _capture(fused_stft, "stft_power_cuda") as calls:
        bd.detect_batch(stack)
        torch.cuda.synchronize()
    del stack
    torch.cuda.empty_cache()
    err, rel, _ = _stft_at_main_path("learned: batched facade", calls,
                                     (LEARNED_BATCH * nx, ns))
    del calls
    if not worst <= LEARNED_CHUNK_ABS:
        fail(f"learned: the batched facade's scores are {worst:.3e} from the per-file call's "
             f"(limit {LEARNED_CHUNK_ABS})")
    notes.append(
        f"BatchedLearnedDetector at [{LEARNED_BATCH}, {nx}, {ns}]: serial {walls[True][0] * 1e3:.1f}"
        f" ms, peak {walls[True][1] / 2**30:.2f} GiB, picks bitwise the per-file calls'; batched "
        f"(CNN passes of {LEARNED_BATCH_ROWS} rows) {walls[False][0] * 1e3:.1f} ms, peak "
        f"{walls[False][1] / 2**30:.2f} GiB, scores within {worst:.3e} of the per-file calls', "
        f"{n_diff} picks differing (knife "
        f"edges); fused_stft within {rel:.2e} * max of plain at the slab's launch "
        f"[{LEARNED_BATCH * nx}, {ns}]")
    return walls[False][2], err


def _learned_campaigns(meta, nx, notes):
    """Both campaign entries with ``family="learned"`` over the slab phase's
    four 12000-sample TDMS files on the card (batch 4, full width; ``run_campaign`` over ``LEARNED_FILE_CAMPAIGN_FILES`` of them), every
    file done at ``batched:4`` (else the rung served is named) and every
    injected call picked; ``fused_stft`` launched once a slab and once a
    file; the same campaigns on the CPU over every ``LEARNED_CPU_STRIDE``-th
    channel, records equal (status, rung, attempts, family) and those
    channels' picks equal up to knife edges. Returns ``(launches, err)``."""
    import shutil

    import torch

    from das4whales_tpu_torch.io.stream import stream_batched_slabs
    from das4whales_tpu_torch.models.learned import LearnedDetector, load_pretrained
    from das4whales_tpu_torch.ops import fused_stft
    from das4whales_tpu_torch.workflows import campaign as cmod

    shared = slab_files()
    files = [p for p, (_, ns) in zip(shared["paths"], SLAB_FILES) if ns == CANONICAL[1]]
    scenes = dict(zip(shared["paths"], shared["scenes"]))
    sub = [0, nx, LEARNED_CPU_STRIDE]
    kw = dict(metadata=meta, interrogator="silixa", family="learned")
    # the per-file entry over LEARNED_FILE_CAMPAIGN_FILES of them (a cut for
    # the run's time limit): the service phase's learned tenant is held to
    # the batched entry's picks over all four
    entries = ((cmod.run_campaign_batched, dict(batch=LEARNED_BATCH), files),
               (cmod.run_campaign, {}, files[:LEARNED_FILE_CAMPAIGN_FILES]))
    res, walls, launches, err, rel = {}, {}, 0, 0.0, 0.0
    n_files = {}
    for entry, extra, efiles in entries:
        out = shared["dir"] / f"learned_{entry.__name__}_cuda"
        shutil.rmtree(out, ignore_errors=True)
        zero_launches()
        n_files[entry.__name__] = len(efiles)
        with _capture(fused_stft, "stft_power_cuda") as calls:
            t0 = time.perf_counter()
            res[(entry.__name__, "cuda")] = entry(efiles, [0, nx, 1], str(out), **kw, **extra)
            torch.cuda.synchronize()
            walls[entry.__name__] = time.perf_counter() - t0
        got = read_launches()
        batched = entry is cmod.run_campaign_batched
        want = 1 if batched else len(efiles)
        if got != {"fused_picks": 0, "fused_stft": want}:
            fail(f"learned: {entry.__name__} launched {got}, expected {want} fused_stft")
        launches += got["fused_stft"]
        e, r, _ = _stft_at_main_path(f"learned: {entry.__name__}", calls,
                                     ((LEARNED_BATCH if batched else 1) * nx, CANONICAL[1]))
        if batched and {x.rung for x in res[(entry.__name__, "cuda")].records} == {
                f"batched:{LEARNED_BATCH}"}:
            # the service phase holds its learned tenant to these picks
            shared["learned_picks"] = _saved_picks(res[(entry.__name__, "cuda")])
        err, rel = max(err, e), max(rel, r)
        del calls
        res[(entry.__name__, "cpu")] = entry(efiles, sub, str(shared["dir"] / f"learned_"
                                             f"{entry.__name__}_cpu"), device="cpu", **kw, **extra)
    cpu_det = LearnedDetector(*load_pretrained(), device="cpu")
    blocks = {}
    for slab in stream_batched_slabs(files, sub, meta, batch=1, bucket="exact",
                                     interrogator="silixa", as_numpy=True):
        blocks[slab.paths[0]] = slab.stack[0]
    for name, want_rung in (("run_campaign_batched", f"batched:{LEARNED_BATCH}"),
                            ("run_campaign", "file")):
        ca, cb = res[(name, "cuda")], res[(name, "cpu")]
        ra = [(os.path.basename(r.path), r.status, r.rung, r.family, r.attempts)
              for r in ca.records]
        rb = [(os.path.basename(r.path), r.status, r.rung, r.family, r.attempts)
              for r in cb.records]
        moves = _downshifts(shared["dir"] / f"learned_{name}_cuda")
        if {(r[1], r[3]) for r in ra} != {("done", "learned")}:
            fail(f"learned: {name}: records on the card {ra}")
        if moves:
            notes.append(f"{name} on the card downshifted {moves}: served at "
                         f"{sorted({r[2] for r in ra})}")
        elif ra != rb or {r[2] for r in ra} != {want_rung}:
            fail(f"learned: {name}: records card {ra} vs cpu {rb}")
        n_diff = 0
        for x, y in zip(ca.records, cb.records):
            pa, pb = cmod.load_picks(x.picks_file), cmod.load_picks(y.picks_file)
            if _check_calls(scenes[x.path], pa):
                fail(f"learned: {name}: {x.path}: an injected call was missed")
            keep = pa["CALL"][0] % LEARNED_CPU_STRIDE == 0
            a = np.asarray([pa["CALL"][0][keep] // LEARNED_CPU_STRIDE, pa["CALL"][1][keep]])
            r = cpu_det(blocks[x.path])
            n_diff += _learned_knife(f"learned: {name}: {x.path}", a, pb["CALL"], r.scores,
                                     r.centers, 0.5)
        notes.append(f"{name}(family='learned') over {n_files[name]} canonical TDMS files: card "
                     f"{walls[name]:.1f} s, reads included, at {sorted({r[2] for r in ra})}, "
                     f"every injected call picked; records equal to the CPU's over every "
                     f"{LEARNED_CPU_STRIDE}th channel, {n_diff} of those channels' picks "
                     "differing (knife edges)")
    notes.append(f"the campaigns' fused_stft launches within {rel:.2e} * max of plain")
    for d in shared["dir"].glob("learned_*"):
        shutil.rmtree(d, ignore_errors=True)
    return launches, err


def phase_learned(scene=None, raw=None):
    """The learned CNN family on the canonical block, conditioned on the
    host, through ``family_detector("learned", ...)`` with the pretrained
    ``fin_cnn`` at full width: timed runs, stage walls, one ``fused_stft``
    launch and one read a call, the kernel against its plain version at
    the route's launch, the peak, the injected calls, a profile; the
    kernel alone at this shape; the tiled view against the one-program
    sweep; the batched facade; both campaign entries. Returns
    ``(launches, err, {...})``."""
    import torch

    from das4whales_tpu_torch.ops import fused_stft
    from das4whales_tpu_torch.workflows.campaign import family_detector

    if raw is None:
        scene, raw = _canonical_block()
    t_phase = time.perf_counter()
    nx, ns = raw.shape
    meta = scene.metadata
    x = torch.as_tensor(_condition_on_host(raw, meta.scale_factor)).to("cuda")
    det = family_detector("learned", meta, [0, nx, 1], (nx, ns))
    cfg = det.cfg
    if (det.device.type, det.row_chunk, cfg.compute_dtype, cfg.nfft, cfg.hop) != (
            "cuda", None, "float32", 128, 32):
        fail(f"learned: the detector resolved {det.device}, row_chunk {det.row_chunk}, {cfg}")
    det(x)                                    # warm-up: cuDNN's algorithm choice, kernel load
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()                           # the main path's runs start here
    det.syncs = 0
    walls, stages, deltas, res = _timed_runs(
        lambda hook: det(x, stage_hook=hook),
        {"launches": lambda: fused_stft.launches, "syncs": lambda: det.syncs})
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    if launches["fused_picks"] or any(d != {"launches": 1, "syncs": 1} for d in deltas):
        fail(f"learned: runs launched and read {deltas}, {launches}; expected one fused_stft "
             "launch and one read a call")
    n_win = (1 + ns // cfg.hop - cfg.win_frames) // cfg.win_stride + 1
    if res.scores.shape != (nx, n_win) or not np.all((res.scores >= 0) & (res.scores <= 1)):
        fail(f"learned: scores of shape {res.scores.shape}, range "
             f"[{res.scores.min()}, {res.scores.max()}]")
    p = res.picks["CALL"]
    if p.shape[0] != 2 or not (np.all((p[0] >= 0) & (p[0] < nx)) and np.all((p[1] >= 0)
                                                                               & (p[1] < ns))):
        fail(f"learned: picks of shape {p.shape} or outside the block")
    misses = _check_calls(scene, res.picks)
    if misses:
        fail(f"learned: injected calls missed {misses}")
    wall = statistics.median(walls)
    fams = _profile("LearnedDetector call", lambda: det(x), wall, "fused_stft")
    with _capture(fused_stft, "stft_power_cuda") as calls:
        det(x)
        torch.cuda.synchronize()
    err, rel, _ = _stft_at_main_path("learned", calls, (nx, ns))
    del calls

    # the kernel alone at the learned shape, beside its plain version and
    # torch.stft + power
    nfft, hop = cfg.nfft, cfg.hop
    kern = dict(ms=_cuda_ms(lambda: fused_stft.stft_power_cuda(x, nfft, hop), 20),
                device_ms=_device_ms(lambda: fused_stft.stft_power_cuda(x, nfft, hop), 20,
                                     "fused_stft", required=False),
                plain_ms=_cuda_ms(lambda: fused_stft.stft_power_plain(x, nfft, hop), 3),
                library_ms=_cuda_ms(lambda: _torch_stft_power(x, nfft, hop), 10),
                **_stft_bounds(nx, ns, nfft, hop))
    torch.cuda.empty_cache()
    conv_ops = LEARNED_CONV_OPS * nx * n_win

    # the tiled view (window rows in chunks) against the one-program sweep
    notes = []
    tv = det.tiled_view()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r_t = tv(x)
    torch.cuda.synchronize()
    t_tiled = time.perf_counter() - t0
    e_t = float(np.abs(r_t.scores - res.scores).max())
    if not e_t <= LEARNED_CHUNK_ABS:
        fail(f"learned: the tiled view's scores are {e_t:.3e} from the one-program sweep's")
    n_t = _learned_knife("learned: tiled view", res.picks["CALL"], r_t.picks["CALL"],
                         res.scores, res.centers, res.thresholds["CALL"], LEARNED_CHUNK_ABS)
    notes.append(f"tiled view ({tv.row_chunk}-row CNN passes) {t_tiled * 1e3:.1f} ms, scores "
                 f"{'bitwise' if e_t == 0 else f'within {e_t:.3e} of'} the one-program "
                 f"sweep's ({nx * n_win} rows in one pass: conv1's padded input "
                 f"{nx * n_win * cfg.features[0] * 17 * 5:.3e} elements), {n_t} picks differing")
    del r_t, tv
    torch.cuda.empty_cache()
    batched_launches, b_err = _learned_facade(det, x, notes)
    torch.cuda.empty_cache()
    card = {"scores": res.scores, "centers": res.centers, "picks": res.picks["CALL"],
            "rows": _learned_rows(scene, nx)}
    rows = card["rows"]
    card["x_rows"] = x[rows].cpu().numpy()
    del x, det
    torch.cuda.empty_cache()
    camp_launches, c_err = _learned_campaigns(meta, nx, notes)
    minutes = ns / meta.fs / 60.0
    # the device's share of the wall from the CUDA-event stage walls (the
    # stages before finalize run on the card; finalize is the read and the
    # host's NMS): the profiler has dropped records of this call's kernels
    med = _median_stages(stages)
    dev_ms = med["stft"] + med["features"] + med["cnn"]
    say(f"learned: {nx}x{ns} conditioned float32, family_detector('learned') with the "
        f"pretrained fin_cnn (nfft {nfft}, hop {hop}, {cfg.win_frames}-frame windows every "
        f"{cfg.win_stride}, {cfg.fmax_bin} bins, features {cfg.features}, float32, TF32 off): "
        f"{nx * n_win} windows; median wall {wall * 1e3:.1f} ms (runs "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms); stage walls (median, CUDA events) "
        f"{json.dumps(med)} ms; per run (fused_stft launches, syncs) "
        f"{[tuple(d.values()) for d in deltas]}; device stages (stft, features, cnn) "
        f"{dev_ms:.3f} ms = {100 * dev_ms / (wall * 1e3):.1f} % of the median wall; picks {p.shape[1]} "
        f"({p.shape[1] / (nx * minutes):.3f} per channel-minute), every injected call picked "
        f"on its nearest channel within 1 s; peak device memory {peak / 2**30:.2f} GiB; "
        f"fused_stft within {rel:.2e} * max of its plain version at the route's launch; the "
        f"CNN's convolutions {conv_ops:.3e} operations -> {conv_ops / F32_OPS_PER_S * 1e3:.2f} ms "
        f"at 67 TFLOP/s f32")
    dev = kern["device_ms"]
    dev_txt = ("not measured: the profiler kept no launch" if dev is None
               else f"{dev:.4f} ms")
    say(f"learned: fused_stft alone at {nx}x{ns} nfft {nfft} hop {hop}: {kern['ms']:.4f} ms a "
        f"call (device time {dev_txt}), plain {kern['plain_ms']:.3f} ms, "
        f"torch.stft + power {kern['library_ms']:.3f} ms; bound {kern['bound_ms']:.4f} ms by "
        f"{kern['bound_by']} (bytes {kern['bytes']:.3e} -> {kern['bytes_ms']:.4f} ms; FFT-form "
        f"operations {kern['ops']:.3e} -> {kern['ops_ms']:.4f} ms); kernel at "
        f"{100 * kern['bound_ms'] / kern['ms']:.1f} % of its bound; {cfg.fmax_bin} of its "
        f"{nfft // 2 + 1} bins kept, {4 * nx * (nfft // 2 + 1 - cfg.fmax_bin) * (1 + ns // hop):.3e}"
        f" bytes written and thrown away")
    say(f"learned: {'; '.join(notes)}; phase {time.perf_counter() - t_phase:.1f} s")
    return ({"learned": launches["fused_stft"], "learned_batched": batched_launches,
             "campaign_learned": camp_launches}, max(err, b_err, c_err),
            {"wall_ms": wall * 1e3, "peak": peak, "kernel": kern, "fams": fams, "card": card})


def _learned_fit_scenes():
    """The JAX package's learned test scenes (32 x 3000 at 8 m, noise
    0.08): two training scenes and the held-out one."""
    from das4whales_tpu_torch.io.synth import SyntheticCall, SyntheticScene

    def scene(seed, amps):
        calls = [SyntheticCall(t0=3.0 + 4.5 * k, x0_m=100.0 + 60 * k, amplitude=a)
                 for k, a in enumerate(amps)]
        return SyntheticScene(nx=32, ns=3000, dx=8.0, noise_rms=0.08, calls=calls, seed=seed)

    return [scene(s, [0.6, 0.9]) for s in range(2)], scene(99, [0.8, 0.7])


def phase_learned_cpu_vs_card(card=None):
    """The learned family on the card against ``device="cpu"``: the card's
    full-width scores on the channels near the calls (``card`` from the
    ``learned`` phase; recomputed at full width on the card when absent)
    against the CPU's on the same rows, within ``LEARNED_CARD_ABS``, picks
    up to knife edges; then ``fit`` on the card and on the CPU (the JAX
    package's test scenes, 25 epochs): loss histories within
    ``LEARNED_FIT_REL`` and the card's model finding the held-out scene's
    calls."""
    import torch

    from das4whales_tpu_torch.models import learned as lmod

    t_phase = time.perf_counter()
    if card is None:
        scene, raw = _canonical_block()
        x = torch.as_tensor(_condition_on_host(raw, scene.metadata.scale_factor)).to("cuda")
        r = lmod.LearnedDetector(*lmod.load_pretrained())(x)
        rows = _learned_rows(scene, raw.shape[0])
        card = {"scores": r.scores, "centers": r.centers, "picks": r.picks["CALL"],
                "rows": rows, "x_rows": x[rows].cpu().numpy()}
        del x, raw
    rows = np.asarray(card["rows"])
    cpu = lmod.LearnedDetector(*lmod.load_pretrained(), device="cpu")(card["x_rows"])
    ref = card["scores"][rows]
    e = float(np.abs(cpu.scores - ref).max())
    if not e <= LEARNED_CARD_ABS:
        fail(f"learned_cpu_vs_card: scores {e:.3e} apart (limit {LEARNED_CARD_ABS})")
    keep = np.isin(card["picks"][0], rows)
    a = np.asarray([np.searchsorted(rows, card["picks"][0][keep]), card["picks"][1][keep]])
    n_diff = _learned_knife("learned_cpu_vs_card", a, cpu.picks["CALL"], cpu.scores,
                            cpu.centers, 0.5)

    train, held = _learned_fit_scenes()
    hist, models, fit_s = {}, {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        models[dev], hist[dev] = lmod.fit(lmod.LearnedConfig(), train, epochs=25, batch=512,
                                          seed=0, device=dev)
        fit_s[dev] = time.perf_counter() - t0
    h_card, h_cpu = np.asarray(hist["cuda"]), np.asarray(hist["cpu"])
    e_fit = float(np.max(np.abs(h_card - h_cpu) / np.abs(h_cpu)))
    if not e_fit <= LEARNED_FIT_REL:
        fail(f"learned_cpu_vs_card: fit's loss histories {e_fit:.3e} apart (relative; limit "
             f"{LEARNED_FIT_REL}): card {h_card.tolist()}, cpu {h_cpu.tolist()}")
    if not (h_card[-1] < 0.1 and h_card[-1] < 0.3 * h_card[0]):
        fail(f"learned_cpu_vs_card: fit on the card did not converge: {h_card.tolist()}")
    from das4whales_tpu_torch.io.synth import synthesize_scene

    trained = lmod.LearnedDetector(models["cuda"], lmod.LearnedConfig())
    picked = trained(torch.as_tensor(synthesize_scene(held), dtype=torch.float32).cuda())
    misses = _check_calls(held, picked.picks)
    if misses:
        fail(f"learned_cpu_vs_card: the model trained on the card missed {misses} of the "
             "held-out scene's calls")
    say(f"learned_cpu_vs_card: the card's full-width scores on {len(rows)} channels near the "
        f"calls against device='cpu' on the same rows: within {e:.3e} (limit "
        f"{LEARNED_CARD_ABS}), picks {a.shape[1]} on the card, {n_diff} differing (knife "
        f"edges); fit (JAX's test scenes, 2 x 32 x 3000, 25 epochs, batch 512) card "
        f"{fit_s['cuda']:.1f} s, cpu {fit_s['cpu']:.1f} s, loss histories within {e_fit:.3e} "
        f"(relative; limit {LEARNED_FIT_REL}), final loss card {h_card[-1]:.5f} / cpu "
        f"{h_cpu[-1]:.5f}; the card's model picks both held-out calls "
        f"({picked.picks['CALL'].shape[1]} picks on 32 x 3000); phase "
        f"{time.perf_counter() - t_phase:.1f} s")



# ---------------------------------------------------------------------------
# Phases 21-26: the reference DSP API, detect -> localize -> evaluate, and
# the long record (ROADMAP items 16 and 11)
# ---------------------------------------------------------------------------

#: the host jobs of the DSP and long-record phases (the f-k designs, the
#: long record's files) run in a pool of this many spawned processes,
#: beside the card's work (each job peaks at 8-25 GB of host memory at
#: full width)
HOST_WORKERS = 4
#: the samples of the designers' and the speed fan's host jobs (the
#: canonical channels; 3000, not 12000, for the run's time limit: at 12000
#: their ~230 s of host CPU ran beside the long record's design and reads)
DSP_DESIGN_SAMPLES = 3000
#: the five f-k designers of the reference's dsp.py
FK_DESIGNERS = ("fk_filter_design", "hybrid_filter_design", "hybrid_ninf_filter_design",
                "hybrid_gs_filter_design", "hybrid_ninf_gs_filter_design")
#: the FFT ops card against CPU: within this times max|cpu| (float32)
DSP_REL = 1e-5
#: ``instant_freq`` card against CPU: a wrapped phase step this close to
#: pi (rad) may unwrap either way on the two devices
IF_KNIFE_RAD = 1e-3
#: the exact IIR at full width is cut to fewer channels past this wall
IIR_EXACT_MAX_S = 60.0
#: the exact IIR against scipy on unit-rms float64 data: the tolerances of
#: tests/test_chunked.py (sosfiltfilt_chunked vs unchunked scipy) and
#: tests/test_filters.py (the order-16 (b, a) of bp_filt(mode="exact"))
IIR_SCIPY_ATOL = {"sosfiltfilt_chunked": 1e-7, "bp_filt_exact": 5e-6}
IIR_SCIPY_ROWS = 64
IIR_CHUNK = 3000
#: JAX's tests/test_detect_localize.py bounds: |x| error, ||y| error|,
#: t0 error, residual RMS
LOC_BOUNDS = {"x_m": 20.0, "y_m": 100.0, "t0_s": 0.05, "rms_s": 0.02}
#: the localize scene's calls: (t0 s, x0 as a fraction of the cable, y0 m,
#: note); z0 = -20 m
LOC_CALLS = ((10.0, 0.35, 300.0, "HF"), (25.0, 0.5, -1000.0, "LF"), (40.0, 0.65, 3000.0, "HF"))
LOC_Z0 = -20.0
#: the recall the localize phase holds the detector to is over the
#: (call, channel) cells clear of the f-k fan's taper (apparent speed along
#: the cable at most this times the fan's cp_max: a broadside arrival is
#: faster than the fan passes, by design) and of the channel FFT's wrap
#: (at least LOC_EDGE channels from either end)
LOC_FAN_MARGIN = 0.9
LOC_EDGE = 32
LOC_EVENTS = 4096
LOC_CPU_EVENTS = 64
LOC_RTOL = 1e-9
#: the long record: two files of the canonical shape, one call straddling
#: the boundary (its onset on its nearest channel this many samples
#: before the break: the HF note's 137 samples split 68 / 69)
LONG_FILES = 2
LONG_STRADDLE = 68
#: the long-row item of the longrecord phase: a record of LONG_ROW_FILES
#: consecutive files at LONG_ROW_CHANNELS channels, whose rows of
#: LONG_ROW_SAMPLES samples are past one CTA's shared memory (about 52800 at
#: K = 512 topk, 55000 at K = 256), so every pick launch takes the kernel's
#: long-row form. 2000 channels: the Gabor step needs C x 0.1 whole and more
#: rows than its channel halo (1040 at the defaults); a channel cut of the
#: canonical 22050, listed in PERF.md
LONG_ROW_FILES = 5
LONG_ROW_CHANNELS = 2000
LONG_ROW_SAMPLES = LONG_ROW_FILES * CANONICAL[1]
#: rows of the kernels phase's long-row launch
LONG_ROW_ROWS = 512


def _host_pool():
    """A pool of ``HOST_WORKERS`` spawned processes for the host jobs (no
    CUDA in them); the caller shuts it down."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    return ProcessPoolExecutor(HOST_WORKERS, mp_context=multiprocessing.get_context("spawn"))


def _designer_job(name: str, shape: tuple, dx: float, fs: float):
    """One f-k designer at ``shape`` in a worker: ``(name, host seconds,
    shape, max, all finite)``."""
    from das4whales_tpu_torch.ops import fk

    t0 = time.perf_counter()
    m = getattr(fk, name)(shape, [0, shape[0], 1], dx, fs)
    s = time.perf_counter() - t0
    return name, s, m.shape, float(np.max(m)), bool(np.isfinite(m).all())


def _speed_fan_job(shape: tuple, fs: float, dx: float):
    """``speed_fan_mask`` (fk_filt's design, sigma 20) in a worker, as a
    designer job."""
    from das4whales_tpu_torch.ops import fk

    t0 = time.perf_counter()
    m = fk.speed_fan_mask(shape, fs, dx, 1400.0, 3500.0)
    s = time.perf_counter() - t0
    return "speed_fan_mask", s, m.shape, float(np.max(m)), bool(np.isfinite(m).all())


def dsp_host_designs(scene, pool) -> list:
    """Start the DSP phase's host jobs in ``pool``: the five f-k designers
    and the speed fan at the block's shape. Returns their futures for
    :func:`report_host_designs`."""
    nx, ns = CANONICAL[0], DSP_DESIGN_SAMPLES
    meta = scene.metadata
    return ([pool.submit(_speed_fan_job, (nx, ns), meta.fs, meta.dx)]
            + [pool.submit(_designer_job, n, (nx, ns), meta.dx, meta.fs) for n in FK_DESIGNERS])


def report_host_designs(futures: list) -> dict:
    """Wait for :func:`dsp_host_designs`' jobs, check each design (the
    block's shape, finite, a positive maximum) and print their host
    seconds. Returns ``{name: seconds}``."""
    nx, ns = CANONICAL[0], DSP_DESIGN_SAMPLES
    secs = {}
    for f in futures:
        name, s, shape, mx, finite = f.result()
        if tuple(shape) != (nx, ns) or not finite or not mx > 0:
            fail(f"dsp: {name} gave shape {shape}, max {mx}, finite {finite}")
        secs[name] = s
    say(f"dsp: host designs at {nx}x{ns} ({HOST_WORKERS} at a time in spawned processes, "
        f"beside the card's phases), seconds each "
        f"{json.dumps({k: round(v, 1) for k, v in secs.items()})}; fk_filt = the speed "
        f"fan's design + fk_filter_apply (above)")
    return secs


def _design_job(shape: tuple, metadata, path: str | None = None, **kw):
    """A fin design over every channel in a worker: ``(host seconds,
    design)``; ``kw`` goes to ``design_matched_filter``. With ``path`` the
    design goes to that checkpoint (``utils.checkpoint.save_design``) and
    the job returns the path in its place: a worker's result crosses to
    the main process as one pickle, and a record's design is gigabytes
    (the main process took a minute and more to take one while it ran a
    phase)."""
    from das4whales_tpu_torch.models.matched_filter import design_matched_filter
    from das4whales_tpu_torch.utils.checkpoint import save_design

    t0 = time.perf_counter()
    d = design_matched_filter(shape, [0, shape[0], 1], metadata, templates="fin", **kw)
    s = time.perf_counter() - t0
    return s, (d if path is None else save_design(path, d))


def _loaded(result) -> tuple:
    """``(host seconds, design)`` of a :func:`_design_job` result, its
    checkpoint loaded where it gave a path."""
    from das4whales_tpu_torch.utils.checkpoint import load_design

    s, d = result
    return s, (load_design(d) if isinstance(d, str) else d)


def _slab_files_job(d: str, k: int | None = None):
    """:func:`_write_files` of the slab files (or of file ``k`` alone) in a
    worker: ``(seconds, (paths, scenes))``."""
    from pathlib import Path

    specs = SLAB_FILES if k is None else SLAB_FILES[k:k + 1]
    paths, scenes, t_write = _write_files(Path(d), specs, CANONICAL[0], n_calls=6,
                                          k0=0 if k is None else k)
    return t_write, (paths, scenes)


class _JoinedFiles:
    """The slab files written one a worker, read back as one job:
    ``result()`` gives ``(the longest file's seconds, (paths, scenes))``."""

    def __init__(self, futs):
        self.futs = futs

    def result(self):
        parts = [f.result() for f in self.futs]
        return (max(p[0] for p in parts),
                ([q for p in parts for q in p[1][0]], [q for p in parts for q in p[1][1]]))


#: host work of later phases started in the run's pool right after the
#: ``kernels`` phase (:func:`early_host_jobs`): futures by name
_EARLY: dict = {}


def early_host_jobs(pool) -> None:
    """Start in ``pool`` the host work the card would otherwise wait for
    later, beside the ``detect`` phase's own set-up (which waits for it
    before its first timed run): the channel-padded canonical design
    (``channel_pad``), the slab files and the fin design at their 16384
    bucket (``slab``), each slab file in a job of its own. The directory
    for the files is made here (``slab_files`` removes it)."""
    import tempfile
    from pathlib import Path

    nx, ns = CANONICAL
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    d = Path(tempfile.mkdtemp(prefix="slab_files_", dir=root))
    _SHARED["dir"] = d
    slab_meta = _scene(nx, SLAB_FILES[0][1], n_calls=6, seed=SLAB_FILES[0][0]).metadata
    _EARLY.update(
        channel_pad=pool.submit(_design_job, (nx, ns), _scene(nx, ns, 6, SEED).metadata,
                                path=str(d / "channel_pad_design.npz"), channel_pad="auto"),
        slab_design=pool.submit(_design_job, (nx, SLAB_BUCKET), slab_meta,
                                path=str(d / "slab_design.npz")),
        **{f"slab_file{k}": pool.submit(_slab_files_job, str(d), k)
           for k in range(len(SLAB_FILES))})


def _build_tmp():
    """A directory of this run under ``build/`` for host jobs' checkpoints
    (removed with the others at the end of main)."""
    import tempfile
    from pathlib import Path

    if "tmp" not in _HOST_TMP:
        root = Path(__file__).resolve().parent / "build"
        root.mkdir(exist_ok=True)
        _HOST_TMP["tmp"] = Path(tempfile.mkdtemp(prefix="host_jobs_", dir=root))
    return _HOST_TMP["tmp"]


#: the run's host-job directory (:func:`_build_tmp`)
_HOST_TMP: dict = {}


def _await_early() -> float:
    """Wait for every early host job; returns the seconds waited. The
    ``detect`` phase calls it before its first timed run: a busy host
    starves the card's launches (its idle share rose to 88 % beside
    them)."""
    from concurrent.futures import wait

    t0 = time.perf_counter()
    wait(list(_EARLY.values()))
    return time.perf_counter() - t0


def _early(name: str, make):
    """``(host seconds, value)`` of the early host job ``name``, or of
    ``make()`` here when none was started (``--only``)."""
    fut = _EARLY.pop(name, None)
    if fut is not None:
        return _loaded(fut.result())
    t0 = time.perf_counter()
    value = make()
    return time.perf_counter() - t0, value


def _long_files_job(d: str, nx: int, nfile: int, seed: int, n_files: int = LONG_FILES):
    """:func:`_long_files` in a worker: ``(paths, scene, straddle channel,
    straddle onset, seconds)``."""
    from pathlib import Path

    t0 = time.perf_counter()
    Path(d).mkdir(parents=True, exist_ok=True)
    out = _long_files(Path(d), nx, nfile, seed, n_files)
    return (*out, time.perf_counter() - t0)


def long_record_prep(pool) -> dict:
    """Start the long record's host work in ``pool``: its two TDMS files,
    written under ``build/``, and the record's fin design. Returns
    ``{"dir", "files", "design", "halo_design", "spectro_design",
    "gabor_design"}`` (futures) for :func:`phase_longrecord` (the last
    three, designs of the record's ``MESH_HALO_CHANNELS``,
    ``MESH_SPECTRO_CHANNELS`` and ``MESH_GABOR_CHANNELS`` channels, for the
    mesh phase's halo, spectro and Gabor runs); main removes the
    directory."""
    import tempfile
    from pathlib import Path

    from das4whales_tpu_torch.io.synth import SyntheticScene

    nx, nfile = CANONICAL
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    d = Path(tempfile.mkdtemp(prefix="long_files_", dir=root))
    meta = SyntheticScene(nx=nx, ns=LONG_FILES * nfile).metadata
    out = {"dir": d, "files": pool.submit(_long_files_job, str(d), nx, nfile, SEED + 7),
           "long_rows": pool.submit(_long_files_job, str(d / "long_rows"), LONG_ROW_CHANNELS,
                                    nfile, SEED + 11, LONG_ROW_FILES),
           "long_rows_design_path": str(d / "long_rows_design.npz")}
    out["long_rows_design"] = pool.submit(
        _design_job, (LONG_ROW_CHANNELS, LONG_ROW_SAMPLES),
        SyntheticScene(nx=LONG_ROW_CHANNELS, ns=LONG_ROW_SAMPLES).metadata,
        path=out["long_rows_design_path"])
    for key, rows in (("design", nx), ("halo_design", MESH_HALO_CHANNELS),
                      ("spectro_design", MESH_SPECTRO_CHANNELS),
                      ("gabor_design", MESH_GABOR_CHANNELS)):
        out[f"{key}_path"] = str(d / f"{key}.npz")
        out[key] = pool.submit(_design_job, (rows, LONG_FILES * nfile), meta,
                               path=out[f"{key}_path"])
    return out


def _unit_rms64(raw: np.ndarray) -> np.ndarray:
    """float64 demeaned counts scaled to unit rms: the exact IIR's input
    (scipy's tolerances are stated for unit-variance data)."""
    x = raw.astype(np.float64)
    x -= x.mean(axis=1, keepdims=True)
    x /= float(np.sqrt(np.mean(x * x)))
    return x


def _iir_exact(fn, x, label: str, notes: list):
    """``fn`` on the card at the full channel count when a short probe
    predicts it within ``IIR_EXACT_MAX_S``, else on the most channels that
    fit (a power of two), with the cut printed. Returns ``(y, seconds,
    rows)``."""
    import torch

    C, T = x.shape
    probe_T = 1200
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(x[:, :probe_T])
    torch.cuda.synchronize()
    per_sample = (time.perf_counter() - t0) / probe_T
    predict = per_sample * T
    rows = C
    if predict > IIR_EXACT_MAX_S:
        rows = 1 << int(np.floor(np.log2(max(1.0, C * IIR_EXACT_MAX_S / predict))))
        notes.append(f"{label} predicted {predict:.1f} s at {C} channels (probe {probe_T} "
                     f"samples); cut to {rows} channels")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = fn(x[:rows])
    torch.cuda.synchronize()
    return y, time.perf_counter() - t0, rows


def phase_dsp(scene=None, raw=None, design=None, host_jobs=None):
    """The reference DSP API on the canonical block: ``bp_filt`` (fft),
    ``taper_data``, ``instant_freq``, ``fk_filter_apply`` against
    ``fk_filter_apply_rfft`` (on the canonical design's mask: the apply's
    time does not depend on the mask's values), each a call's wall by
    CUDA events; the exact IIR (``sosfiltfilt_chunked``,
    ``bp_filt(mode="exact")``) in float64 at full width, against scipy on
    ``IIR_SCIPY_ROWS`` channels. The five f-k designers' and the speed
    fan's host seconds at 22050 x ``DSP_DESIGN_SAMPLES`` come from ``host_jobs``
    (:func:`dsp_host_designs`, reported by the caller later), or from a
    pool of its own here. Returns the walls."""
    import scipy.signal as sps
    import torch

    from das4whales_tpu_torch.ops import chunked, filters, fk, spectral

    if design is None:
        scene, raw, design = _canonical_inputs()
    t_phase = time.perf_counter()
    pool = _host_pool() if host_jobs is None else None
    if pool is not None:
        host_jobs = dsp_host_designs(scene, pool)
    try:
        nx, ns = raw.shape
        meta = scene.metadata
        x = torch.as_tensor(_condition_on_host(raw, meta.scale_factor)).to("cuda")
        ms, notes = {}, []
        ms["bp_filt"] = _cuda_ms(lambda: filters.bp_filt(x, meta.fs, 14.0, 30.0), 3)
        ms["taper_data"] = _cuda_ms(lambda: spectral.taper_data(x), 3)
        ms["instant_freq"] = _cuda_ms(lambda: spectral.instant_freq(x, meta.fs), 3)
        for name, fn in (("bp_filt", lambda: filters.bp_filt(x, meta.fs, 14.0, 30.0)),
                         ("taper_data", lambda: spectral.taper_data(x)),
                         ("instant_freq", lambda: spectral.instant_freq(x, meta.fs))):
            y = fn()
            if tuple(y.shape) != (nx, ns - (name == "instant_freq")) or not bool(
                    torch.isfinite(y).all()):
                fail(f"dsp: {name} gave {tuple(y.shape)} or non-finite values")
            del y

        # the exact IIR in float64: its serial length is T (bp_filt) or the
        # halo window chunk + 2*halo (sosfiltfilt_chunked), not the channels
        sos = sps.butter(8, [14 / (meta.fs / 2), 30 / (meta.fs / 2)], "bp", output="sos")
        b, a = filters.butter_bandpass_ba(8, 14.0, 30.0, meta.fs)
        x64_host = _unit_rms64(raw[:, :ns])
        x64 = torch.as_tensor(x64_host).to("cuda")
        iir = {}
        for label, fn, want in (
                ("sosfiltfilt_chunked", lambda v: chunked.sosfiltfilt_chunked(sos, v, IIR_CHUNK),
                 lambda v: sps.sosfiltfilt(sos, v, axis=-1)),
                ("bp_filt_exact", lambda v: filters.bp_filt(v, meta.fs, 14.0, 30.0,
                                                            mode="exact"),
                 lambda v: sps.filtfilt(b, a, v, axis=-1))):
            y, s, rows = _iir_exact(fn, x64, label, notes)
            ref = want(x64_host[:IIR_SCIPY_ROWS])
            e = float(np.abs(y[:IIR_SCIPY_ROWS].cpu().numpy() - ref).max())
            if not e <= IIR_SCIPY_ATOL[label]:
                fail(f"dsp: {label} on the card is {e:.3e} from scipy on {IIR_SCIPY_ROWS} "
                     f"channels (limit {IIR_SCIPY_ATOL[label]})")
            iir[label] = (s, rows, e)
            del y
        del x64
        torch.cuda.empty_cache()

        mask = torch.as_tensor(design.fk_mask).to("cuda")
        ms["fk_filter_apply"] = _cuda_ms(lambda: fk.fk_filter_apply(x, mask), 3)
        ms["fk_filter_apply_rfft"] = _cuda_ms(lambda: fk.fk_filter_apply_rfft(x, mask), 3)
        full, half = fk.fk_filter_apply(x, mask), fk.fk_filter_apply_rfft(x, mask)
        scale = float(full.abs().max())
        e_fk = float((full - half).abs().max())
        if not (scale > 0 and e_fk <= DSP_REL * scale):
            fail(f"dsp: fk_filter_apply and fk_filter_apply_rfft {e_fk:.3e} apart (limit "
                 f"{DSP_REL * scale:.3e})")
        del full, half, mask, x
        torch.cuda.empty_cache()
        say(f"dsp: {nx}x{ns} conditioned float32 on the card, a call by CUDA events (ms) "
            f"{json.dumps({k: round(v, 3) for k, v in ms.items()})}; fk_filter_apply_rfft "
            f"within {e_fk / scale:.2e} * max of fk_filter_apply; the exact IIR in float64 "
            f"(unit-rms data; serial length: bp_filt {ns + 2 * 3 * len(b)} samples a pass, "
            f"sosfiltfilt_chunked chunk {IIR_CHUNK} + 2 halos + 2 pads = "
            f"{IIR_CHUNK + 2 * 48 * (2 * len(sos) + 1) + 2 * 3 * (2 * len(sos) + 1)} a pass): "
            + "; ".join(f"{k} {s:.2f} s at {r} channels, {e:.2e} from scipy on "
                        f"{IIR_SCIPY_ROWS}" for k, (s, r, e) in iir.items())
            + (f"; {'; '.join(notes)}" if notes else "")
            + f"; phase {time.perf_counter() - t_phase:.1f} s")
        if pool is not None:
            report_host_designs(host_jobs)
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)
    return {"ms": ms, "iir": iir}


def phase_dsp_cpu_vs_card():
    """The DSP ops on the card against ``device="cpu"`` at 512 x 12000:
    float32 FFT ops within ``DSP_REL * max|cpu|`` (``instant_freq``: 8
    float32 ulps of its largest unwrapped phase, in Hz), the exact IIR in
    float64 within 1e-10 on unit-rms data."""
    import scipy.signal as sps
    import torch

    from das4whales_tpu_torch.io.synth import synthesize_scene, to_raw_counts
    from das4whales_tpu_torch.ops import chunked, filters, fk, spectral, xcorr

    nx, ns = 512, CANONICAL[1]
    scene = _scene(nx, ns, n_calls=1, seed=SEED + 1)
    meta = scene.metadata
    raw = to_raw_counts(synthesize_scene(scene), meta)
    xc = torch.as_tensor(_condition_on_host(raw, meta.scale_factor))
    xg = xc.to("cuda")
    tmpl = torch.as_tensor(np.hanning(137) * np.cos(np.linspace(0, 120, 137)), dtype=torch.float32)
    ops = {
        "bp_filt": lambda v: filters.bp_filt(v, meta.fs, 14.0, 30.0),
        "fk_filt": lambda v: fk.fk_filt(v, 1.0, meta.fs, 1.0, meta.dx, 1400.0, 3500.0),
        "fk_filter_apply_rfft": lambda v: fk.fk_filter_apply_rfft(
            v, fk.hybrid_ninf_filter_design((nx, ns), [0, nx, 1], meta.dx, meta.fs)),
        "taper_data": lambda v: spectral.taper_data(v),
        "fx_transform": lambda v: spectral.fx_transform(v, 16384),
        "compute_cross_correlogram": lambda v: xcorr.compute_cross_correlogram(
            v, tmpl.to(v.device)),
        "fk_filt_chunked": lambda v: chunked.fk_filt_chunked(v, 3000, 1.0, meta.fs, 1.0,
                                                             meta.dx, 1400.0, 3500.0),
    }
    errs = {}
    for name, fn in ops.items():
        c = fn(xc).numpy()
        g = fn(xg).cpu().numpy()
        e = float(np.abs(g - c).max()) / float(np.abs(c).max())
        if not e <= DSP_REL:
            fail(f"dsp_cpu_vs_card: {name} card {e:.3e} * max from the CPU (limit {DSP_REL})")
        errs[name] = e
    c = spectral.instant_freq(xc, meta.fs).numpy()
    g = spectral.instant_freq(xg, meta.fs).cpu().numpy()
    phase = float(spectral.unwrap(torch.angle(spectral.analytic_signal(xc.double())))
                  .abs().max())
    bound = 8 * np.finfo(np.float32).eps * phase * meta.fs / (2 * np.pi)
    # a wrapped phase step within IF_KNIFE_RAD of pi is a knife edge of the
    # unwrap: the two devices may correct it either way, which moves that one
    # sample's frequency by fs
    dd = np.diff(torch.angle(spectral.analytic_signal(xc)).numpy(), axis=-1)
    knife = np.abs(np.abs(dd) - np.pi) <= IF_KNIFE_RAD
    diff = np.abs(g - c)
    flips = diff > bound
    if not np.all(knife[flips] & (np.abs(diff[flips] - meta.fs) <= bound)):
        bad = np.argwhere(flips & ~knife)[:5].tolist()
        fail(f"dsp_cpu_vs_card: instant_freq card {float(diff.max()):.3e} Hz from the CPU "
             f"(limit {bound:.3e}) at samples no unwrap knife edge explains {bad}")
    e_if = float(diff[~flips].max())
    n_flips = int(flips.sum())
    sos = sps.butter(8, [14 / (meta.fs / 2), 30 / (meta.fs / 2)], "bp", output="sos")
    x64 = torch.as_tensor(_unit_rms64(raw[:64]))
    iir = {}
    for name, fn in (("sosfiltfilt_chunked", lambda v: chunked.sosfiltfilt_chunked(sos, v,
                                                                                   IIR_CHUNK)),
                     ("bp_filt_exact", lambda v: filters.bp_filt(v, meta.fs, 14.0, 30.0,
                                                                 mode="exact"))):
        e = float((fn(x64.to("cuda")).cpu() - fn(x64)).abs().max())
        if not e <= 1e-10:
            fail(f"dsp_cpu_vs_card: {name} float64 card {e:.3e} from the CPU (limit 1e-10)")
        iir[name] = e
    say(f"dsp_cpu_vs_card: {nx}x{ns} float32, card against device='cpu', max|card - cpu| / "
        f"max|cpu| {json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} (limit "
        f"{DSP_REL}); instant_freq {e_if:.3e} Hz (limit {bound:.3e} Hz: 8 float32 ulps of the "
        f"largest unwrapped phase) but for {n_flips} samples moved by fs at unwrap knife "
        f"edges (a wrapped step within {IF_KNIFE_RAD} rad of pi); the exact IIR in float64 on 64 channels "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in iir.items()})} (limit 1e-10)")


def _loc_scene(nx: int, ns: int, seed: int):
    """Three off-cable calls (``LOC_CALLS``) on a straight cable."""
    from das4whales_tpu_torch.io.synth import SyntheticCall, SyntheticScene

    notes = {"HF": {"fmin": 17.8, "fmax": 28.8, "duration": 0.68},
             "LF": {"fmin": 14.7, "fmax": 21.8, "duration": 0.78}}
    span = nx * 2.042
    calls = [SyntheticCall(t0=t0, x0_m=frac * span, y0_m=y0, z0_m=LOC_Z0, amplitude=1.0,
                           **notes[note]) for t0, frac, y0, note in LOC_CALLS]
    return SyntheticScene(nx=nx, ns=ns, noise_rms=0.05, calls=calls, seed=seed)


def _call_template(i: int) -> str:
    return LOC_CALLS[i][3]


def _localize_errors(lr, call) -> dict:
    x, y, z, t0 = (float(v) for v in lr.position.cpu().numpy())
    rms = float(np.sqrt(np.nanmean(lr.residuals.cpu().numpy() ** 2)))
    return {"x_m": abs(x - call.x0_m), "y_m": abs(abs(y) - abs(call.y0_m)),
            "t0_s": abs(t0 - call.t0), "rms_s": rms, "z_m": abs(z - call.z0_m)}


def _fan_recall(scene, picks: dict, fk_cfg) -> dict:
    """Per template: the recall ``evaluate_detector`` scores and the recall
    over the cells clear of the fan's taper and the channel wrap (see
    ``LOC_FAN_MARGIN``)."""
    from das4whales_tpu_torch import eval as teval

    x = np.arange(scene.nx) * scene.dx
    edge = (np.arange(scene.nx) >= LOC_EDGE) & (np.arange(scene.nx) < scene.nx - LOC_EDGE)
    out = {}
    for name in picks:
        idx = [i for i in range(len(scene.calls)) if _call_template(i) == name]
        pm = teval.match_picks(picks[name], scene, call_indices=idx)
        clear = np.zeros_like(pm.covered)
        for r, ci in enumerate(idx):
            c = scene.calls[ci]
            rr = np.sqrt((x - c.x0_m) ** 2 + c.y0_m ** 2 + c.z0_m ** 2)
            v = c.speed * rr / np.maximum(np.abs(x - c.x0_m), 1e-9)
            clear[r] = pm.covered[r] & edge & (v <= LOC_FAN_MARGIN * fk_cfg.cp_max)
        out[name] = {"recall": pm.recall,
                     "clear_recall": (float(pm.hits[clear].sum() / clear.sum())
                                      if clear.any() else float("nan")),
                     "clear_cells": int(clear.sum()), "covered_cells": int(pm.covered.sum())}
    return out


def _loc_events(cable: np.ndarray, n: int, seed: int, c0: float = 1500.0) -> np.ndarray:
    """``[n, nch]`` float64 arrival times of random off-cable sources
    (x over the middle 80 % of the cable, |y| 300 m - 3 km, z -20 m), the
    forward model plus 1 ms Gaussian noise."""
    rng = np.random.default_rng(seed)
    span = float(cable[-1, 0])
    src = np.stack([rng.uniform(0.1, 0.9, n) * span,
                    rng.choice([-1.0, 1.0], n) * rng.uniform(300.0, 3000.0, n),
                    np.full(n, LOC_Z0), rng.uniform(0.0, 10.0, n)], axis=1)
    d = np.sqrt(((cable[None, :, :] - src[:, None, :3]) ** 2).sum(-1))
    return src[:, 3:] + d / c0 + 1e-3 * rng.standard_normal(d.shape)


def _unc_rtol(cable, cpu, Ti, c0: float, fix_z: bool):
    """Per event, the relative tolerance of the uncertainty card against
    CPU: ``max(LOC_RTOL, 8 * eps * cond(G^T G))`` of the normal matrix the
    covariance inverts (LU inverses of two libraries differ by up to
    cond * eps, and at 1/c0 against 1 columns cond reaches 1e7-1e8)."""
    import torch

    from das4whales_tpu_torch import loc

    cable_t = torch.as_tensor(np.asarray(cable, np.float64))
    G = loc._design_matrix(cable_t, cpu.position, c0, fix_z=False)
    if fix_z:
        G = torch.cat([G[..., :2], G[..., 3:]], dim=-1)
    G = G * torch.isfinite(torch.as_tensor(np.asarray(Ti))).to(G.dtype)[..., None]
    cond = torch.linalg.cond(G.transpose(-1, -2) @ G).numpy()
    return np.maximum(LOC_RTOL, 8 * np.finfo(np.float64).eps * cond), float(cond.max())


def _loc_close(label: str, card, cpu, unc_rtol, t_scale) -> float:
    """Every field of two ``LocalizationResult``s within ``LOC_RTOL``
    relative, with an absolute floor of 1e-12 of each field's scale; the
    uncertainty within ``unc_rtol`` an event (:func:`_unc_rtol`); the
    residuals ``Ti - pred`` within ``LOC_RTOL * t_scale`` absolute (an
    event's largest arrival time: the difference of two 10-60 s times
    keeps their rounding, and positions within ``LOC_RTOL`` move
    ``pred`` by up to that), and so the variance, their mean square,
    within ``2 * sqrt(var) * LOC_RTOL * t_scale`` more. Returns each
    field's largest error over its tolerance (at most 1) as one printable
    string."""
    worst = {}
    t_scale = np.asarray(t_scale, np.float64)
    for name, g, c in zip(card._fields, card, cpu):
        g, c = g.cpu().numpy(), c.numpy()
        if g.shape != c.shape or not np.array_equal(np.isnan(g), np.isnan(c)):
            fail(f"{label}: {name} {g.shape} / NaNs differ from the CPU's {c.shape}")
        fin = np.isfinite(c)
        err = np.abs(g - c)
        if name == "residuals":
            ref = np.broadcast_to(t_scale[..., None], c.shape)
            tol = LOC_RTOL * ref
        else:
            ref = np.abs(c)
            rtol = (np.broadcast_to(np.asarray(unc_rtol)[..., None], c.shape)
                    if name == "uncertainty" else LOC_RTOL)
            scale = float(np.abs(c[fin]).max()) if fin.any() else 0.0
            tol = rtol * ref + 1e-12 * scale
            if name == "variance":
                tol = tol + 2 * np.sqrt(np.abs(c)) * LOC_RTOL * t_scale
        if not np.all(err[fin] <= tol[fin]):
            fail(f"{label}: {name} card vs CPU beyond its tolerance: max relative "
                 f"{float((err[fin] / np.maximum(ref[fin], 1e-300)).max()):.3e}")
        worst[name] = float((err[fin] / np.maximum(tol[fin], 1e-300)).max()) if fin.any() \
            else 0.0
    return ("max error / tolerance: " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
            + f" (rtol {LOC_RTOL}; residuals of the arrival times; uncertainty 8 eps "
            "cond(G^T G) an event)")


def phase_localize(design=None):
    """detect -> localize -> evaluate on the card at full width: a 22050 x
    12000 scene with three off-cable calls (``LOC_CALLS``), the matched
    filter's ``__call__`` on the canonical design (44 ``fused_picks``
    launches an attempt, the kernel bitwise its plain version at the
    first and last launch), ``localize_scene_call`` a call within JAX's
    ``test_detect_localize`` bounds, ``evaluate_detector`` (its own 44
    launches) with recall 1.0 on the cells clear of the fan's taper;
    ``localize_batch`` of ``LOC_EVENTS`` events in float64 on the card,
    ``LOC_CPU_EVENTS`` of them against the CPU within ``LOC_RTOL``.
    Returns ``({"localize": launches, "eval": launches}, err)``."""
    import torch

    from das4whales_tpu_torch import eval as teval
    from das4whales_tpu_torch import loc
    from das4whales_tpu_torch.config import SCRIPT_FK
    from das4whales_tpu_torch.io.synth import synthesize_scene
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.ops import fused_picks

    t_phase = time.perf_counter()
    nx, ns = CANONICAL
    if design is None:
        design = _canonical_inputs()[2]
    scene = _loc_scene(nx, ns, SEED + 3)
    det = MatchedFilterDetector.from_design(design, scene.metadata, templates="fin")
    if (det.pick_mode, det._route()) != ("sparse", "tiled"):
        fail(f"localize: the detector resolved {det.pick_mode!r}, {det._route()!r}")
    tile = det.effective_channel_tile
    n_tiles = -(-nx // tile)
    nT = len(design.template_names)
    block = torch.as_tensor(synthesize_scene(scene), dtype=torch.float32).to("cuda")
    det(block)                                # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()                           # the localize path's detect starts here
    det.escalations = 0
    with _capture(fused_picks, "picks_cuda") as calls:
        timer = StageTimer()
        t0 = time.perf_counter()
        res = det(block, stage_hook=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches_loc = read_launches()["fused_picks"]
    if launches_loc != n_tiles * (1 + det.escalations):
        fail(f"localize: __call__ launched the pick kernel {launches_loc} times with "
             f"{det.escalations} escalations, expected {n_tiles} an attempt")
    err, knotes = _picks_at_main_path("localize", calls, {
        "first": nT * tile, "last": nT * (nx - (n_tiles - 1) * tile)})
    del calls
    peak = torch.cuda.max_memory_allocated()
    del block
    torch.cuda.empty_cache()

    loc_notes, t_loc = [], 0.0
    for i, call in enumerate(scene.calls):
        t0 = time.perf_counter()
        lr = teval.localize_scene_call(res.picks[_call_template(i)], scene, call_index=i,
                                       device="cuda")
        torch.cuda.synchronize()
        t_loc += time.perf_counter() - t0
        e = _localize_errors(lr, call)
        if e["z_m"] != 0.0 or any(not e[k] <= LOC_BOUNDS[k] for k in LOC_BOUNDS):
            fail(f"localize: call {i} (x0 {call.x0_m:.1f}, y0 {call.y0_m}, t0 {call.t0}): "
                 f"errors {e} beyond {LOC_BOUNDS}")
        loc_notes.append(f"call {i} ({_call_template(i)}, y0 {call.y0_m:+.0f} m): |dx| "
                         f"{e['x_m']:.3f} m, ||y|-|y0|| {e['y_m']:.3f} m, |dt0| "
                         f"{e['t0_s'] * 1e3:.3f} ms, rms {e['rms_s'] * 1e3:.3f} ms")

    zero_launches()                           # the eval path starts here
    t0 = time.perf_counter()
    metrics = teval.evaluate_detector(det, scene)
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    launches_eval = read_launches()["fused_picks"]
    if launches_eval < n_tiles:
        fail(f"localize: evaluate_detector launched the pick kernel {launches_eval} times")
    recall = _fan_recall(scene, res.picks, SCRIPT_FK)
    for name, r in recall.items():
        if metrics[name]["recall"] != r["recall"]:
            fail(f"localize: evaluate_detector's {name} recall {metrics[name]['recall']} != "
                 f"the __call__ picks' {r['recall']}")
        if r["clear_recall"] != 1.0:
            fail(f"localize: template {name}: recall {r['clear_recall']} over the "
                 f"{r['clear_cells']} cells clear of the fan's taper and the wrap (limit 1.0)")
    del det

    cable = teval.scene_cable_positions(scene)
    Ti = _loc_events(cable, LOC_EVENTS, SEED + 4)
    Ti_d = torch.as_tensor(Ti).to("cuda")
    cable_d = torch.as_tensor(cable).to("cuda")
    loc.localize_batch(Ti_d[:8], cable_d, 1500.0, n_iter=10, fix_z=True)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lb = loc.localize_batch(Ti_d, cable_d, 1500.0, n_iter=10, fix_z=True)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    peak_batch = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    lb_cpu = loc.localize_batch(Ti[:LOC_CPU_EVENTS], cable, 1500.0, n_iter=10, fix_z=True,
                                device="cpu")
    t_cpu = time.perf_counter() - t0
    unc_rtol, cond = _unc_rtol(cable, lb_cpu, Ti[:LOC_CPU_EVENTS], 1500.0, True)
    worst = _loc_close("localize: localize_batch",
                       type(lb)(*(f[:LOC_CPU_EVENTS] for f in lb)), lb_cpu, unc_rtol,
                       np.nanmax(Ti[:LOC_CPU_EVENTS], axis=-1))
    del Ti_d, lb
    torch.cuda.empty_cache()
    say(f"localize: {nx}x{ns} float32 scene, three off-cable calls (z0 {LOC_Z0} m, y0 "
        f"{[c[2] for c in LOC_CALLS]} m); MatchedFilterDetector.from_design(canonical)"
        f"(block) on the card {wall * 1e3:.1f} ms (stage walls "
        f"{json.dumps({k: round(v, 3) for k, v in timer.walls().items()})} ms), "
        f"{launches_loc} fused_picks launches ({n_tiles} tiles), peak "
        f"{peak / 2**30:.2f} GiB, bitwise its plain version: {'; '.join(knotes)}; "
        f"localize_scene_call (float64 on the card, {t_loc:.2f} s for 3): "
        f"{'; '.join(loc_notes)} (bounds {json.dumps(LOC_BOUNDS)}); evaluate_detector "
        f"{t_eval:.1f} s, {launches_eval} fused_picks launches: "
        + "; ".join(f"{n} recall {r['recall']:.4f} over {r['covered_cells']} covered cells, "
                    f"{r['clear_recall']} over the {r['clear_cells']} clear of the fan's taper "
                    f"(apparent speed <= {LOC_FAN_MARGIN} x cp_max {SCRIPT_FK.cp_max:.0f} m/s) "
                    f"and {LOC_EDGE} channels from the ends, precision "
                    f"{metrics[n]['precision']:.4f}, "
                    f"{metrics[n]['false_per_channel_minute']:.4f} false a channel-minute"
                    for n, r in recall.items())
        + f"; localize_batch of {LOC_EVENTS} events x {nx} channels (1 ms noise, fix_z, 10 "
        f"iterations) float64 on the card {t_batch * 1e3:.1f} ms, peak "
        f"{peak_batch / 2**30:.2f} GiB; the CPU {t_cpu:.2f} s for {LOC_CPU_EVENTS} of them, "
        f"card against it: {worst}, cond(G^T G) up to {cond:.2e}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"localize": launches_loc, "eval": launches_eval}, err


def phase_localize_cpu_vs_card():
    """detect -> localize -> evaluate at 512 x 12000 on the card against
    ``device="cpu"``: thresholds rtol 1e-5, picks up to knife edges, the
    localized calls (on equal picks) and ``localize_batch`` of
    ``LOC_EVENTS`` events in float64 within ``LOC_RTOL``."""
    import torch

    from das4whales_tpu_torch import eval as teval
    from das4whales_tpu_torch import loc
    from das4whales_tpu_torch.io.synth import SyntheticCall, SyntheticScene, synthesize_scene
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.utils.parity import envelopes, unexplained_differences

    nx, ns = 512, CANONICAL[1]
    call = SyntheticCall(t0=20.0, x0_m=0.5 * nx * 2.042, y0_m=300.0, z0_m=LOC_Z0,
                         amplitude=2.0)
    scene = SyntheticScene(nx=nx, ns=ns, noise_rms=0.05, calls=[call], seed=SEED + 5)
    block = synthesize_scene(scene).astype(np.float32)
    res, dets = {}, {}
    for dev in ("cuda", "cpu"):
        dets[dev] = MatchedFilterDetector(scene.metadata, [0, nx, 1], (nx, ns), device=dev,
                                          pick_mode="sparse")
        res[dev] = dets[dev](torch.as_tensor(block).to(dev))
    env = envelopes(dets["cpu"], torch.as_tensor(block))
    n_diff, equal = 0, True
    for i, name in enumerate(res["cpu"].picks):
        tg, tc = res["cuda"].thresholds[name], res["cpu"].thresholds[name]
        if not np.isclose(tg, tc, rtol=1e-5, atol=0):
            fail(f"localize_cpu_vs_card: {name} threshold card {tg} vs cpu {tc}")
        a, b = res["cuda"].picks[name], res["cpu"].picks[name]
        bad = unexplained_differences(a, b, env[i], tc)
        if bad:
            fail(f"localize_cpu_vs_card: {name} picks differ beyond rounding at {bad[:10]}")
        d = len({tuple(p) for p in a.T.tolist()} ^ {tuple(p) for p in b.T.tolist()})
        n_diff += d
        equal &= d == 0
    lr = {dev: teval.localize_scene_call(res[dev].picks["HF"], scene, device=dev)
          for dev in ("cuda", "cpu")}
    for dev in lr:
        e = _localize_errors(lr[dev], call)
        if any(not e[k] <= LOC_BOUNDS[k] for k in LOC_BOUNDS):
            fail(f"localize_cpu_vs_card: {dev}: errors {e} beyond {LOC_BOUNDS}")
    w_call = None
    if equal:
        # the residuals are finite on the channels the call kept
        unc_c, _ = _unc_rtol(teval.scene_cable_positions(scene), lr["cpu"],
                             lr["cpu"].residuals.numpy(), 1500.0, True)
        w_call = _loc_close("localize_cpu_vs_card: localize_scene_call", lr["cuda"],
                            lr["cpu"], unc_c, scene.ns / scene.fs)
    m = {dev: teval.evaluate_detector(dets[dev], scene) for dev in ("cuda", "cpu")}
    if equal and json.dumps(m["cuda"], sort_keys=True) != json.dumps(m["cpu"], sort_keys=True):
        fail(f"localize_cpu_vs_card: evaluate_detector card {m['cuda']} vs cpu {m['cpu']}")
    # the events on 512 channels spread over the canonical cable's 45 km
    cable = np.zeros((nx, 3))
    cable[:, 0] = np.linspace(0.0, CANONICAL[0] * 2.042, nx)
    Ti = _loc_events(cable, LOC_EVENTS, SEED + 6)
    lb_cpu = loc.localize_batch(Ti, cable, 1500.0, n_iter=10, fix_z=True, device="cpu")
    unc_rtol, cond = _unc_rtol(cable, lb_cpu, Ti, 1500.0, True)
    worst = _loc_close("localize_cpu_vs_card: localize_batch",
                       loc.localize_batch(Ti, cable, 1500.0, n_iter=10, fix_z=True,
                                          device="cuda"), lb_cpu, unc_rtol,
                       np.nanmax(Ti, axis=-1))
    say(f"localize_cpu_vs_card: {nx}x{ns}, one call at y0 300 m: thresholds within rtol "
        f"1e-5, picks {json.dumps({k: int(v.shape[1]) for k, v in res['cuda'].picks.items()})}"
        f" on the card, {n_diff} differing (knife edges); localize_scene_call "
        + (f"card against the CPU: {w_call}" if equal
           else "within the bounds on both devices (picks differ on knife edges)")
        + f"; evaluate_detector {'equal' if equal else 'not compared'} on both devices; "
        f"localize_batch of {LOC_EVENTS} events x {nx} channels over "
        f"{CANONICAL[0] * 2.042 / 1e3:.1f} km float64, card against the CPU: {worst}, "
        f"cond(G^T G) up to {cond:.2e}")


def _long_files(d, nx: int, nfile: int, seed: int, n_files: int = LONG_FILES):
    """``n_files`` consecutive Silixa TDMS files of ``nfile`` samples
    cut from one ``[nx, n_files * nfile]`` scene: an HF call mid-file
    0, one straddling the first boundary (onset ``LONG_STRADDLE`` samples
    before it on its nearest channel), an LF call mid-file 1; past two
    files, an HF call straddling the last boundary and one mid the last
    file. Returns ``(paths, scene, straddle channel, straddle onset)``."""
    from datetime import datetime, timedelta

    from das4whales_tpu_torch.io.synth import (
        SyntheticCall,
        SyntheticScene,
        synthesize_scene,
        to_raw_counts,
    )
    from das4whales_tpu_torch.io.tdms import write_tdms

    ns = n_files * nfile
    fs, dx = 200.0, 2.042
    ch_s = int(0.55 * nx)
    onset = nfile - LONG_STRADDLE
    calls = [SyntheticCall(t0=0.4 * nfile / fs, x0_m=0.3 * nx * dx, amplitude=1.0),
             SyntheticCall(t0=onset / fs, x0_m=ch_s * dx, amplitude=1.0),
             SyntheticCall(t0=1.5 * nfile / fs, x0_m=0.75 * nx * dx, amplitude=1.0,
                           fmin=14.7, fmax=21.8, duration=0.78)]
    if n_files > 2:
        calls += [SyntheticCall(t0=((n_files - 1) * nfile - LONG_STRADDLE) / fs,
                                x0_m=0.45 * nx * dx, amplitude=1.0),
                  SyntheticCall(t0=(n_files - 0.5) * nfile / fs, x0_m=0.2 * nx * dx,
                                amplitude=1.0)]
    scene = SyntheticScene(nx=nx, ns=ns, noise_rms=0.05, calls=calls, seed=seed)
    raw = to_raw_counts(synthesize_scene(scene), scene.metadata)
    paths = []
    start = datetime(2021, 11, 4, 2, 0, 0)
    for k in range(n_files):
        props = {"SamplingFrequency[Hz]": fs, "SpatialResolution[m]": dx,
                 "FibreIndex": float(scene.n), "GaugeLength": float(scene.gauge_length),
                 "GPSTimeStamp": start + timedelta(seconds=k * nfile / fs)}
        seg = raw[:, k * nfile:(k + 1) * nfile]
        paths.append(write_tdms(str(d / f"long{k}.tdms"), props, "Measurement",
                                {f"ch{i:05d}": seg[i] for i in range(nx)}))
    return paths, scene, ch_s, onset


def _picked_near(pk: np.ndarray, ch: int, onset: int, tol: float) -> bool:
    sel = pk[1][pk[0] == ch]
    return bool(np.any(np.abs(sel - onset) <= tol))


def _record_env(x, blocks, design, meta):
    """The long record's envelopes ``[nT, C, T]`` on ``x``'s device, for
    the knife-edge margin."""
    from das4whales_tpu_torch.ops import spectral
    from das4whales_tpu_torch.workflows import longrecord as lr

    corr = lr._mf_record_correlograms(x, blocks, design, meta, "conditioned", lambda n: None)
    return spectral.envelope_sqrt(corr)


def _same_picks(label, a: dict, b: dict, env_fn, thr: dict) -> int:
    """Picks of ``a`` and ``b`` equal, or differing only on knife edges of
    ``env_fn()`` (computed only when they differ); returns the count of
    differing picks."""
    from das4whales_tpu_torch.utils.parity import unexplained_differences

    n = 0
    for i, name in enumerate(a):
        sa = {tuple(p) for p in np.asarray(a[name]).T.tolist()}
        sb = {tuple(p) for p in np.asarray(b[name]).T.tolist()}
        if sa == sb:
            continue
        env = env_fn()
        bad = unexplained_differences(a[name], b[name], env[i], thr[name])
        if bad:
            fail(f"{label}: {name} picks differ beyond rounding at {bad[:10]}")
        n += len(sa ^ sb)
    return n


def _record_pickers(corr, rec, design) -> dict:
    """The pick stage of the time-split mf step on one card, on the
    record's own correlograms ``[nT, C, T]`` at the record's thresholds:
    the kernel's route (``models.matched_filter.mf_pick_tiled``: per
    512-row tile the Hilbert transform and ``fused_picks``, K=512
    ``topk``, as ``timeshard.make_sharded_mf_step_time`` runs it) against
    the plain tiled picker it replaces (the envelope, then
    ``ops.peaks.find_peaks_sparse_tiled``), each once by CUDA events after
    a warm-up; the picks compared. A measurement: its launches count on
    no path."""
    import torch

    from das4whales_tpu_torch.models.matched_filter import mf_pick_tiled
    from das4whales_tpu_torch.ops import peaks as peak_ops
    from das4whales_tpu_torch.ops import spectral
    from das4whales_tpu_torch.workflows.longrecord import PICK_TILE

    thr = torch.as_tensor([rec.thresholds[n] for n in design.template_names],
                          dtype=torch.float32, device=corr.device)
    K = 512

    def kernel():
        return mf_pick_tiled(list(corr.split(PICK_TILE, dim=-2)), thr, K, "topk")

    def plain():
        return peak_ops.find_peaks_sparse_tiled(spectral.envelope_sqrt(corr, dim=-1),
                                                thr[:, None], max_peaks=K, tile=PICK_TILE,
                                                method="topk")

    out = {}
    for name, fn in (("kernel", kernel), ("plain", plain)):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        sp = fn()
        b.record()
        torch.cuda.synchronize()
        out[name] = (a.elapsed_time(b), sp)
    n_diff = 0
    for t in range(len(design.template_names)):
        ka = peak_ops.sparse_to_pick_times(out["kernel"][1].positions[t].cpu().numpy(),
                                           out["kernel"][1].selected[t].cpu().numpy())
        pa = peak_ops.sparse_to_pick_times(out["plain"][1].positions[t].cpu().numpy(),
                                           out["plain"][1].selected[t].cpu().numpy())
        n_diff += len({tuple(p) for p in ka.T.tolist()} ^ {tuple(p) for p in pa.T.tolist()})
    return {"kernel_ms": out["kernel"][0], "plain_ms": out["plain"][0], "n_diff": n_diff,
            "tiles": -(-corr.shape[-2] // PICK_TILE)}


def phase_longrecord(prep=None, design12=None):
    """``detect_long_record`` on the card over two consecutive 22050 x
    12000 int32 TDMS files (written, with the record's design, by
    ``prep`` = :func:`long_record_prep`'s host jobs, or here when None;
    the design's host seconds printed): the matched filter on both wires,
    the straddling call picked on both and the two wires' picks
    equal, no ``fused_picks`` launch (the plain tiled picker, as JAX's
    route); ``detect_picks`` file by file beside it, with the correlogram
    peaks that show the straddle weakened (on ``design12``, the canonical
    design, made here when None); then the learned family over
    the same record: one ``fused_stft`` launch of 22050 x 24000 within
    ``STFT_REL_TOL`` * max of the plain version, the straddling call
    picked; then the spectro and Gabor families over the record at full
    width on a mesh of one, the straddling call picked by both, the Gabor
    step's one ``fused_picks`` launch bitwise plain. Returns
    ``({"longrecord_learned": launches}, err, {"longrecord_gabor":
    launches}, picks err)``."""
    import tempfile
    from pathlib import Path

    import torch

    from das4whales_tpu_torch.io.stream import stream_strain_blocks
    from das4whales_tpu_torch.models import learned as lmod
    from das4whales_tpu_torch.models.matched_filter import (
        MatchedFilterDetector,
        design_matched_filter,
    )
    from das4whales_tpu_torch.ops import fused_picks, fused_stft, xcorr
    from das4whales_tpu_torch.workflows import longrecord as lr
    from das4whales_tpu_torch.workflows.longrecord import detect_long_record

    t_phase = time.perf_counter()
    nx, nfile = CANONICAL
    ns = LONG_FILES * nfile
    if prep is None:
        root = Path(__file__).resolve().parent / "build"
        root.mkdir(exist_ok=True)
        d = Path(tempfile.mkdtemp(prefix="long_files_", dir=root))
    else:
        d = prep["dir"]
    try:
        if prep is None:
            paths, scene, ch_s, onset, t_write = _long_files_job(str(d), nx, nfile, SEED + 7)
            t_design, design = _design_job((nx, ns), scene.metadata)
            t_wait = t_wait_files = 0.0
        else:
            t0 = time.perf_counter()
            paths, scene, ch_s, onset, t_write = prep["files"].result()
            t_wait_files = time.perf_counter() - t0
            t_design, design = _loaded(prep["design"].result())
            t_wait = time.perf_counter() - t0
        sel = [0, nx, 1]
        runs = {}
        for wire in ("conditioned", "raw"):
            zero_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            timer = StageTimer()
            t0 = time.perf_counter()
            # the format reader on both wires: the native reader conditions in
            # float64, the raw wire's host means are the float32 readers'
            r = detect_long_record(paths, sel, interrogator="silixa", wire=wire, design=design,
                                   engine="h5py", stage_hook=timer)
            torch.cuda.synchronize()
            runs[wire] = dict(res=r, wall=time.perf_counter() - t0, stages=timer.walls(),
                              peak=torch.cuda.max_memory_allocated(),
                              launches=read_launches())
            if r.n_samples != ns or r.n_files != LONG_FILES:
                fail(f"longrecord: {wire}: {r.n_files} files, {r.n_samples} samples")
            if any(runs[wire]["launches"].values()):
                fail(f"longrecord: {wire}: the mf long record launched "
                     f"{runs[wire]['launches']}; its picker is the plain tiled one")
            pk = r.picks["HF"]
            if not _picked_near(pk, ch_s, onset, scene.fs):
                fail(f"longrecord: {wire}: the straddling call (channel {ch_s}, onset "
                     f"{onset}) was not picked")
            misses = _check_calls(scene, r.picks)
            if misses:
                fail(f"longrecord: {wire}: injected calls missed {misses}")
            for name, p in r.picks.items():
                if p.shape[1] and not (p[1].max() < ns and p[0].max() < nx):
                    fail(f"longrecord: {wire}: {name} picks outside the record")
        blocks = list(stream_strain_blocks(paths, sel, interrogator="silixa", as_numpy=True,
                                           engine="h5py"))
        meta = blocks[0].metadata
        rec = runs["conditioned"]["res"]

        def env_fn():
            x = torch.as_tensor(np.concatenate([b.trace for b in blocks], axis=-1)).to("cuda")
            return _record_env(x, blocks, design, meta).cpu().numpy()

        n_wire = _same_picks("longrecord: raw against conditioned wire", rec.picks,
                             runs["raw"]["res"].picks, env_fn, rec.thresholds)

        # file by file: detect_picks on the canonical design, and the
        # straddling call's correlogram peak against the mid-file call's
        t0 = time.perf_counter()
        d12 = design12 or design_matched_filter((nx, nfile), sel, scene.metadata,
                                                templates="fin")
        t_d12 = time.perf_counter() - t0
        det = MatchedFilterDetector.from_design(d12, meta, wire="conditioned")
        ch_m = int(round(scene.calls[0].x0_m / scene.dx))
        on_m = int(round(scene.calls[0].t0 * scene.fs))
        t_true, mu, sc = (torch.as_tensor(a).to("cuda")
                          for a in xcorr.padded_template_stats(d12.templates))
        per_file, peaks_pf = [], {}
        for k, b in enumerate(blocks):
            xb = torch.as_tensor(b.trace).to("cuda")
            pf = det.detect_picks(xb)
            per_file.append(_picked_near(pf.picks["HF"], ch_s, onset - k * nfile, scene.fs))
            trf = det.filter_block(xb)
            rows = trf[[ch_m, ch_s]]
            corr = xcorr.compute_cross_correlograms_corrected(rows, t_true, mu, sc)[0].abs()
            if k == 0:
                peaks_pf["mid"] = float(corr[0, on_m - 100:on_m + 300].max())
                peaks_pf["straddle"] = float(corr[1, onset - 50:].max())
            else:
                peaks_pf["straddle_next"] = float(corr[1, :300].max())
            del xb, trf, corr
        x = torch.as_tensor(np.concatenate([b.trace for b in blocks], axis=-1)).to("cuda")
        corr = lr._mf_record_correlograms(x, blocks, design, meta, "conditioned",
                                          lambda n: None)
        del x
        cc = corr[0].abs()
        peak_c = {"mid": float(cc[ch_m, on_m - 100:on_m + 300].max()),
                  "straddle": float(cc[ch_s, onset - 50:onset + 300].max())}
        del cc
        pick_cmp = _record_pickers(corr, rec, design)
        del corr
        torch.cuda.empty_cache()

        # the learned family over the same record
        model, cfg = lmod.load_pretrained()
        zero_launches()
        torch.cuda.reset_peak_memory_stats()
        with _capture(fused_stft, "stft_power_cuda") as calls:
            t0 = time.perf_counter()
            rl = detect_long_record(paths, sel, interrogator="silixa", family="learned",
                                    family_kwargs={"params": model, "cfg": cfg})
            torch.cuda.synchronize()
            t_learned = time.perf_counter() - t0
        launches_l = read_launches()
        peak_l = torch.cuda.max_memory_allocated()
        if launches_l != {"fused_picks": 0, "fused_stft": 1}:
            fail(f"longrecord: learned: launches {launches_l}, expected one fused_stft")
        err, rel, _ = _stft_at_main_path("longrecord_learned", calls, (nx, ns))
        del calls
        torch.cuda.empty_cache()
        pl = rl.picks["CALL"]
        # a window pick lies at its window's centre: the call's middle
        if not _picked_near(pl, ch_s, onset + 68, 1.5 * scene.fs):
            fail(f"longrecord: learned: the straddling call (channel {ch_s}) was not picked")
        if pl.shape[1] and pl[1].max() >= ns:
            fail("longrecord: learned: a pick lies past the record")

        # the spectro and Gabor families over the same record, full width, on
        # a mesh of one (the record's own design gives the f-k mask)
        fam_runs, fam_err = {}, 0.0
        for fam in ("spectro", "gabor"):
            zero_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            timer = StageTimer()
            with _capture(fused_picks, "picks_cuda") as calls:
                t0 = time.perf_counter()
                rf = detect_long_record(paths, sel, interrogator="silixa", family=fam,
                                        design=design, engine="native", stage_hook=timer)
                torch.cuda.synchronize()
                wall_f = time.perf_counter() - t0
            fl = read_launches()
            want = {"fused_picks": 1 if fam == "gabor" else 0, "fused_stft": 0}
            if fl != want:
                fail(f"longrecord: {fam}: launches {fl}, expected {want} (one pick launch of "
                     "both notes' rows for the Gabor step; rFFT framing for the spectro step)")
            rows = []
            if fam == "gabor":
                fam_err, rows = _rank_kernel_check(calls, "longrecord: gabor")
                if rows != [2 * nx, 2 * nx]:
                    fail(f"longrecord: gabor: the pick launch had {rows} rows, expected {2 * nx}")
            del calls
            if rf.n_samples != ns:
                fail(f"longrecord: {fam}: a record of {rf.n_samples} samples")
            if not _picked_near(rf.picks["HF"], ch_s, onset + 68, 1.5 * scene.fs):
                fail(f"longrecord: {fam}: the straddling call (channel {ch_s}) was not picked")
            fam_runs[fam] = dict(res=rf, wall=wall_f, stages=timer.walls(), rows=rows,
                                 peak=torch.cuda.max_memory_allocated(), launches=fl)
            torch.cuda.empty_cache()
        long_rows = _long_rows_item(d, prep)
        fam_err = max(fam_err, long_rows["err"])
        # the mesh phase holds its time-split record to this one
        if prep is not None:
            # the mesh phase's designs: futures, resolved there (their host
            # jobs run on beside this phase)
            _keep_long_reference(paths, design, scene, ch_s, onset, rec,
                                 {k: prep[f"{k}_design"] for k in ("halo", "spectro", "gabor")},
                                 {k: prep[f"{k}_design_path"]
                                  for k in ("halo", "spectro", "gabor")}
                                 | {"long": prep["design_path"]})
    finally:
        import shutil

        if prep is None:
            # run alone: nothing later needs the files (main removes prep's)
            shutil.rmtree(d, ignore_errors=True)
            _LONG_REF.clear()
    say(f"longrecord: {LONG_FILES} consecutive {nx}x{nfile} int32 TDMS files -> one {nx}x{ns} "
        f"record (written in {t_write:.1f} s) and the record's fin design {t_design:.1f} s on the "
        f"host (in spawned processes beside the earlier phases; waited for {t_wait:.1f} s, "
        f"{t_wait_files:.1f} s of it for the files); "
        f"detect_long_record mf: "
        + "; ".join(f"{w} wire {v['wall']:.2f} s (stage walls "
                    f"{json.dumps({k: round(s, 1) for k, s in v['stages'].items()})} ms), peak "
                    f"{v['peak'] / 2**30:.2f} GiB, picks "
                    f"{json.dumps({k: int(p.shape[1]) for k, p in v['res'].picks.items()})}, "
                    f"thresholds {json.dumps({k: float(f'{t:.6e}') for k, t in v['res'].thresholds.items()})}"
                    for w, v in runs.items())
        + f"; no fused_picks launch (the plain 512-row tiled picker); the straddling call "
        f"(channel {ch_s}, onset {onset}) picked on both wires, the wires' picks (the "
        f"format reader on both) {'equal' if n_wire == 0 else f'{n_wire} apart on knife edges'}"
        f", every injected call "
        f"picked; file by file (canonical design {t_d12:.1f} s here, detect_picks): the straddle "
        f"picked in file 0 {per_file[0]}, in file 1 {per_file[1]}; |correlogram| peak "
        f"straddle / mid-file call: per file {peaks_pf['straddle'] / peaks_pf['mid']:.3f} "
        f"(file 1's head {peaks_pf['straddle_next'] / peaks_pf['mid']:.3f}), continuous "
        f"{peak_c['straddle'] / peak_c['mid']:.3f}; the time-split step's pick stage on "
        f"this record's correlograms on one card (K=512 topk, 512-row tiles, CUDA events): "
        f"through fused_picks ({pick_cmp['tiles']} launches) {pick_cmp['kernel_ms']:.1f} ms "
        f"against the plain tiled picker it replaces {pick_cmp['plain_ms']:.1f} ms, picks "
        f"{'equal' if pick_cmp['n_diff'] == 0 else f'{pick_cmp['n_diff']} apart'}; learned "
        f"family (pretrained fin_cnn): "
        f"{t_learned:.2f} s with the read, 1 fused_stft launch of {nx}x{ns} within "
        f"{rel:.2e} * max of its plain version, peak {peak_l / 2**30:.2f} GiB, "
        f"{pl.shape[1]} picks, the straddling call picked; "
        + "; ".join(f"{fam} family on a mesh of one (the native reader) {v['wall']:.2f} s "
                    f"(stages {json.dumps({k: round(s, 1) for k, s in v['stages'].items()})} "
                    f"ms), peak {v['peak'] / 2**30:.2f} GiB, picks "
                    f"{json.dumps({k: int(p.shape[1]) for k, p in v['res'].picks.items()})}, "
                    f"thresholds "
                    f"{json.dumps({k: float(f'{t:.6e}') for k, t in v['res'].thresholds.items()})}"
                    f", the straddling call picked"
                    + (f", 1 fused_picks launch of {v['rows'][0]} x {ns} bitwise plain"
                       if fam == "gabor" else ", no kernel launch (rFFT framing)")
                    for fam, v in fam_runs.items())
        + f"; {long_rows['say']}; phase {time.perf_counter() - t_phase:.1f} s")
    return ({"longrecord_learned": launches_l["fused_stft"]}, err,
            {"longrecord_gabor": fam_runs["gabor"]["launches"]["fused_picks"],
             **{f"longrecord_long_rows_{fam}": v["launches"]
                for fam, v in long_rows["runs"].items()}}, fam_err)


def _long_rows_item(d, prep) -> dict:
    """The pick kernel's long-row form on the main path:
    ``detect_long_record`` over ``LONG_ROW_FILES`` consecutive
    ``LONG_ROW_CHANNELS`` x 12000 files, whose rows of ``LONG_ROW_SAMPLES``
    samples are past one CTA's shared memory: the matched filter on a mesh
    of one (the time-split step) and the Gabor family (its time-split step
    on a mesh of one). Every ``fused_picks`` launch must be the long-row
    form, the first and last bitwise plain, every injected call picked by
    the matched filter (two of them in the last file, past the shared-memory
    limit), the calls straddling the first and the last boundary by Gabor.
    Returns ``{"runs", "err", "say"}``."""
    import torch

    from das4whales_tpu_torch.ops import fused_picks
    from das4whales_tpu_torch.parallel.mesh import make_mesh
    from das4whales_tpu_torch.workflows.longrecord import detect_long_record

    nx, nfile = LONG_ROW_CHANNELS, CANONICAL[1]
    ns = LONG_ROW_SAMPLES
    t0 = time.perf_counter()
    if prep is None:
        paths, scene, ch_s, onset, _ = _long_files_job(str(d / "long_rows"), nx, nfile,
                                                       SEED + 11, LONG_ROW_FILES)
        _, design = _design_job((nx, ns), scene.metadata)
    else:
        paths, scene, ch_s, onset, _ = prep["long_rows"].result()
        _, design = _loaded(prep["long_rows_design"].result())
    t_wait = time.perf_counter() - t0
    last = scene.calls[3]
    ch_l = int(round(last.x0_m / scene.dx))
    on_l = (LONG_ROW_FILES - 1) * nfile - LONG_STRADDLE
    mesh = make_mesh((1,), ("time",), devices=["cuda:0"])
    runs, err = {}, 0.0
    for fam, kw in (("mf", dict(mesh=mesh)), ("gabor", dict(family="gabor"))):
        zero_launches()
        fused_picks.long_launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with _capture(fused_picks, "picks_cuda") as calls:
            t0 = time.perf_counter()
            r = detect_long_record(paths, [0, nx, 1], interrogator="silixa", design=design,
                                   engine="native", **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        n = read_launches()["fused_picks"]
        if n == 0 or fused_picks.long_launches != n:
            fail(f"longrecord: long rows {fam}: {n} fused_picks launches, "
                 f"{fused_picks.long_launches} of them the long-row form; want every one")
        e, rows = _rank_kernel_check(calls, f"longrecord: long rows {fam}")
        err = max(err, e)
        del calls
        if r.n_samples != ns:
            fail(f"longrecord: long rows {fam}: a record of {r.n_samples} samples, want {ns}")
        if fam == "mf":
            misses = _check_calls(scene, r.picks)
            if misses:
                fail(f"longrecord: long rows mf: injected calls missed {misses}")
        else:
            for ch, on in ((ch_s, onset), (ch_l, on_l)):
                if not _picked_near(r.picks["HF"], ch, on + 68, 1.5 * scene.fs):
                    fail(f"longrecord: long rows gabor: the call straddling a boundary "
                         f"(channel {ch}, onset {on}) was not picked")
        runs[fam] = dict(wall=wall, launches=n, rows=rows,
                         peak=torch.cuda.max_memory_allocated(),
                         picks={k: int(p.shape[1]) for k, p in r.picks.items()})
        torch.cuda.empty_cache()
    text = (f"long rows ({LONG_ROW_FILES} consecutive {nx}x{nfile} files, rows of {ns} "
            f"samples; waited {t_wait:.1f} s for their host jobs): "
            + "; ".join(f"{'mf on a mesh of one' if fam == 'mf' else 'gabor'} {v['wall']:.2f} s, "
                        f"{v['launches']} fused_picks launches, every one the long-row form, "
                        f"rows {v['rows']} first and last bitwise plain, peak "
                        f"{v['peak'] / 2**30:.2f} GiB, picks {json.dumps(v['picks'])}"
                        for fam, v in runs.items())
            + ", every injected call picked (mf), the boundary calls picked (gabor)")
    return {"runs": runs, "err": err, "say": text}


def phase_longrecord_cpu_vs_card():
    """``detect_long_record`` at 512 channels over two 12000-sample TDMS
    files on the card against ``device="cpu"``: both wires and the learned
    family, thresholds rtol 1e-5, picks up to knife edges (the learned
    family's of its scores, within ``LEARNED_CARD_ABS``)."""
    import tempfile
    from pathlib import Path

    import torch

    from das4whales_tpu_torch.io.stream import stream_strain_blocks
    from das4whales_tpu_torch.models import learned as lmod
    from das4whales_tpu_torch.models.matched_filter import design_matched_filter
    from das4whales_tpu_torch.workflows.longrecord import detect_long_record

    nx, nfile = 512, CANONICAL[1]
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    d = Path(tempfile.mkdtemp(prefix="long_cpu_", dir=root))
    try:
        paths, scene, ch_s, onset = _long_files(d, nx, nfile, SEED + 8)
        sel = [0, nx, 1]
        blocks = list(stream_strain_blocks(paths, sel, interrogator="silixa", as_numpy=True))
        record = np.concatenate([b.trace for b in blocks], axis=-1)
        design = design_matched_filter(record.shape, sel, blocks[0].metadata, templates="fin")
        notes = []
        for wire in ("conditioned", "raw"):
            r = {dev: detect_long_record(paths, sel, interrogator="silixa", wire=wire,
                                         device=dev, design=design) for dev in ("cuda", "cpu")}
            for name in r["cpu"].thresholds:
                tg, tc = r["cuda"].thresholds[name], r["cpu"].thresholds[name]
                if not np.isclose(tg, tc, rtol=1e-5, atol=0):
                    fail(f"longrecord_cpu_vs_card: {wire}: {name} threshold card {tg} vs "
                         f"cpu {tc}")
            n = _same_picks(
                f"longrecord_cpu_vs_card: {wire}", r["cuda"].picks, r["cpu"].picks,
                lambda: _record_env(torch.as_tensor(record), blocks, design,
                                    blocks[0].metadata).numpy(), r["cpu"].thresholds)
            if not _picked_near(r["cuda"].picks["HF"], ch_s, onset, scene.fs):
                fail(f"longrecord_cpu_vs_card: {wire}: the straddling call was not picked")
            notes.append(f"{wire} wire: picks "
                         f"{json.dumps({k: int(v.shape[1]) for k, v in r['cuda'].picks.items()})}"
                         f" on the card, {n} differing")
        model, cfg = lmod.load_pretrained()
        rl = {dev: detect_long_record(paths, sel, interrogator="silixa", family="learned",
                                      device=dev, family_kwargs={"params": model, "cfg": cfg})
              for dev in ("cuda", "cpu")}
        scores = lmod.LearnedDetector(model, cfg, device="cpu").scores(
            torch.as_tensor(record)).numpy()
        n_l = _learned_knife("longrecord_cpu_vs_card: learned", rl["cuda"].picks["CALL"],
                             rl["cpu"].picks["CALL"], scores,
                             lmod.window_centers(scores.shape[1], cfg), 0.5)
        notes.append(f"learned: {rl['cuda'].picks['CALL'].shape[1]} picks on the card, {n_l} "
                     f"differing (knife edges of the scores within {LEARNED_CARD_ABS})")
    finally:
        import shutil

        shutil.rmtree(d, ignore_errors=True)
    say(f"longrecord_cpu_vs_card: {LONG_FILES} x {nx}x{nfile} TDMS files, card against "
        f"device='cpu': thresholds within rtol 1e-5, the straddling call picked; "
        f"{'; '.join(notes)}")


# ---------------------------------------------------------------------------
# Phases 27-29: the memory preflight and the streaming detection service
# (ROADMAP items 7a and 13)
# ---------------------------------------------------------------------------

#: batch sizes the preflight phase prices each facade at
PREFLIGHT_BATCHES = (1, 2, 4)
#: the service's tenants' batch, freshness target [s] and the learned
#: tenant's memory share as a multiple of its measured B=4 peak
SERVICE_BATCH = 4
SERVICE_SLO_S = 120.0
SERVICE_LEARNED_SHARE = 1.5
#: the tenants' slicer linger: a partial slab waits for its batch-mates
#: until the source ends, so each tenant's slabs are its standalone
#: campaign's (the card's batched mode rounds by the slab it is given;
#: the default 0.25 s flushes whatever a slow read left in the ring)
SERVICE_LINGER_S = 600.0
#: files a tenant of the ``serve`` subprocess detects (two until PR 14, cut
#: to one for the smoke's time budget: the subprocess checks the verb, its
#: exit code and both manifests, not throughput)
SERVE_FILES = 1
#: the endpoints a client polls while the service runs
SERVICE_ENDPOINTS = ("/livez", "/readyz", "/metrics", "/tenants", "/slo", "/quality")
#: the card-vs-CPU service files: 512 channels x 12000 samples, int32
SERVICE_CPU_FILES = ((2060, 12000), (2061, 12000), (2062, 12000), (2063, 12000))

#: the preflight phase's measured peaks, shared with the service phase
_PREFLIGHT: dict = {}


@contextlib.contextmanager
def _probes_marked():
    """Mark the memory preflight's probes for the block: yields ``{"n",
    "s", "active"}`` (probes run, their seconds, and true while one runs:
    its launches run on a zero slab, and :func:`_capture` skips them). On
    the CPU, where no probe measures, the contract gate's recording run of
    a priced program (``memory._run_recorded``) is marked the same way."""
    from das4whales_tpu_torch.utils import memory

    orig = {name: getattr(memory, name) for name in ("_measure", "_run_recorded")}
    got = {"n": 0, "s": 0.0, "active": False}

    def marker(fn):
        def marked(spec):
            got["active"] = True
            t0 = time.perf_counter()
            try:
                return fn(spec)
            finally:
                got["s"] += time.perf_counter() - t0
                got["n"] += 1
                got["active"] = False
        return marked

    for name, fn in orig.items():
        setattr(memory, name, marker(fn))
    try:
        yield got
    finally:
        for name, fn in orig.items():
            setattr(memory, name, fn)


def _service_design(meta, nx: int):
    """The campaign phase's fin design at the 16384 bucket (designed here,
    on the host, when that phase did not run)."""
    design = _SLAB_DESIGN.get("campaign") or _SLAB_DESIGN.get("design")
    if design is None:
        from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector

        design = MatchedFilterDetector(meta, [0, nx, 1], (nx, SLAB_BUCKET),
                                       device="cpu").design
        _SLAB_DESIGN["campaign"] = design
    return design


def _saved_picks(res) -> dict:
    """``{path: picks}`` of a campaign result's done files."""
    from das4whales_tpu_torch.workflows.campaign import load_picks

    return {r.path: load_picks(r.picks_file) for r in res.records if r.status == "done"}


def _same_saved_picks(where: str, got, ref: dict) -> int:
    """Each file's saved picks of a campaign result bitwise ``ref``'s
    (:func:`_saved_picks` of the reference run); returns the files
    compared."""
    from das4whales_tpu_torch.workflows.campaign import load_picks

    n = 0
    for r in got.records:
        a, b = load_picks(r.picks_file), ref[r.path]
        if set(a) != set(b) or any(not np.array_equal(a[k], b[k]) for k in a):
            fail(f"{where}: {os.path.basename(r.path)}: saved picks differ from the "
                 "reference run's")
        n += 1
    return n


def phase_preflight():
    """The memory preflight on the card: the mf facade at [B, 22050, 16384]
    (conditioned wire, health, the campaign phase's design) and the learned
    facade at [B, 22050, 12000] measured for B in 1, 2, 4; then
    ``run_campaign_batched(preflight=True)`` over the slab phase's files
    with ``DAS_HBM_BUDGET_GB`` between the mf B=2 and B=4 peaks: it must
    start at ``batched:2`` with exactly one preflight downshift and no
    out-of-memory error, its picks bitwise a run at batch 2 without it."""
    import shutil

    import torch

    from das4whales_tpu_torch.ops import fused_picks
    from das4whales_tpu_torch.parallel.batch import batched_detector_for
    from das4whales_tpu_torch.utils import memory
    from das4whales_tpu_torch.utils.artifacts import read_records
    from das4whales_tpu_torch.workflows import campaign as cmod

    t_phase = time.perf_counter()
    nx = CANONICAL[0]
    sel = [0, nx, 1]
    shared = slab_files()
    paths, meta = shared["paths"], shared["scenes"][0].metadata
    design = _service_design(meta, nx)
    memory.clear_probe_cache()
    mf = cmod.family_detector("mf", meta, sel, (nx, SLAB_BUCKET), design=design)
    if mf._route() != "tiled":
        fail(f"preflight: the mf facade's route at the default budget is {mf._route()}")
    bds = {"mf": batched_detector_for(mf),
           "learned": batched_detector_for(cmod.family_detector("learned", meta, sel, CANONICAL),
                                           trace_shape=CANONICAL)}
    peaks, secs = {}, {}
    torch.cuda.synchronize()
    with _probes_marked() as probes:
        for fam, bd in bds.items():
            for b in PREFLIGHT_BATCHES:
                t0 = time.perf_counter()
                st = memory.batched_program_memory(bd, b, np.float32, with_health=True)
                secs[(fam, b)] = time.perf_counter() - t0
                if st is None or st.exhausted:
                    fail(f"preflight: {fam} at B={b}: no measured peak ({st})")
                peaks[(fam, b)] = st
    if probes["n"] != len(bds) * len(PREFLIGHT_BATCHES):
        fail(f"preflight: {probes['n']} probes for {len(bds) * len(PREFLIGHT_BATCHES)} programs")
    for fam in bds:
        p = [peaks[(fam, b)].peak for b in PREFLIGHT_BATCHES]
        if not p[0] < p[1] < p[2] < CARD_BYTES:
            fail(f"preflight: {fam} peaks {p} do not grow with B under the card's memory")
    budget = (peaks[("mf", 2)].peak + peaks[("mf", 4)].peak) / 2
    # the campaigns' program stays on the tiled route the facades were
    # priced on (the route at the default budget): the budget moves the
    # batch and nothing else
    kw = dict(metadata=meta, interrogator="silixa", design=design,
              channel_tile=mf.effective_channel_tile)
    out, ref_out = shared["dir"] / "preflight_out", shared["dir"] / "preflight_ref"
    old = os.environ.get("DAS_HBM_BUDGET_GB")
    os.environ["DAS_HBM_BUDGET_GB"] = repr(budget / 2**30)
    try:
        with _probes_marked() as camp_probes:
            t0 = time.perf_counter()
            res = cmod.run_campaign_batched(paths, sel, str(out), preflight=True, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        if old is None:
            os.environ.pop("DAS_HBM_BUDGET_GB", None)
        else:
            os.environ["DAS_HBM_BUDGET_GB"] = old
    moves = [(e["from"], e["to"], e.get("preflight")) for e in
             read_records(str(out / "manifest.jsonl")) if e.get("event") == "downshift"]
    if moves != [("batched:4", "batched:2", True)]:
        fail(f"preflight: downshift events {moves}; expected one preflight move to batched:2")
    recs = [(r.status, r.rung) for r in res.records]
    if recs != [("done", "batched:2")] * len(paths):
        fail(f"preflight: records {recs}; every file must be done at batched:2")
    summary = cmod.summarize_campaign(str(out))
    if summary["oom_recoveries"] or summary["n_failed"]:
        fail(f"preflight: {summary['oom_recoveries']} out-of-memory recoveries, "
             f"{summary['n_failed']} failed")
    # the fleet phase holds its workers' picks to this run: its first pick
    # launch (a full channel tile of the first slab of 2) and its last (the
    # ragged tile of the last slab, of one file when the files are odd)
    # against the plain version
    with _capture(fused_picks, "picks_cuda") as calls:
        t0 = time.perf_counter()
        ref = cmod.run_campaign_batched(paths, sel, str(ref_out), batch=2, **kw)
        ref_wall = time.perf_counter() - t0
    tile, nT = mf.effective_channel_tile, design.templates.shape[0]
    last_nv = len(paths) - 2 * ((len(paths) - 1) // 2)
    picks_err, picks_notes = _picks_at_main_path("preflight", calls, {
        "first": 2 * nT * tile, "last": last_nv * nT * (nx - (-(-nx // tile) - 1) * tile)})
    n_ref_launches = calls["n"]
    del calls
    if [(r.status, r.rung) for r in ref.records] != recs:
        fail(f"preflight: the batch-2 run's records {[(r.status, r.rung) for r in ref.records]}")
    ref_picks = _saved_picks(ref)
    n_same = _same_saved_picks("preflight", res, ref_picks)
    # the service and fleet phases hold their mf tenants (batched:2) to
    # this run's picks
    _PREFLIGHT.update(peaks=peaks, secs=secs, budget=budget, mf_picks=ref_picks,
                      tile=mf.effective_channel_tile, picks_err=picks_err)
    shutil.rmtree(out, ignore_errors=True)
    shutil.rmtree(ref_out, ignore_errors=True)
    gib = 2**30
    say("preflight: measured peaks (slab counted as an argument; the mf program at its "
        "escalation attempt, K=256 topk) and each probe's seconds (its cold first run): "
        + "; ".join(f"{fam} [{b}, {nx}, {SLAB_BUCKET if fam == 'mf' else CANONICAL[1]}] "
                    f"{peaks[(fam, b)].peak / gib:.2f} GiB (of which outputs "
                    f"{peaks[(fam, b)].output_bytes / gib:.3f}) in {secs[(fam, b)]:.3f} s"
                    for fam in bds for b in PREFLIGHT_BATCHES)
        + f"; run_campaign_batched(preflight=True) over {len(paths)} files with "
        f"DAS_HBM_BUDGET_GB={budget / gib:.2f} (between the mf B=2 and B=4 peaks): "
        f"{wall:.1f} s, {camp_probes['n']} new probes ({camp_probes['s']:.2f} s; the rest "
        f"memoized), one preflight downshift batched:4 -> batched:2, every file done at "
        f"batched:2, 0 out-of-memory errors; {n_same} files' picks bitwise the batch-2 run's "
        f"without the preflight ({ref_wall:.1f} s), whose fused_picks launches "
        f"({n_ref_launches}) were bitwise their plain version at the first and the last "
        f"({'; '.join(picks_notes)}); phase {time.perf_counter() - t_phase:.1f} s")
    return _PREFLIGHT


class _ServicePoller:
    """A client thread polling every endpoint and both tenants' NDJSON
    streams (cursor resume, long poll) while a service runs; it keeps
    every answer's code and every stream line."""

    def __init__(self, url: str, tenants):
        import threading

        self.url, self.tenants = url, tuple(tenants)
        self.codes, self.errors = [], []
        self.cursor = {t: 0 for t in self.tenants}
        self.lines = {t: [] for t in self.tenants}
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, name="smoke-poller", daemon=True)

    def _get(self, path: str):
        import urllib.request

        with urllib.request.urlopen(self.url + path, timeout=60) as r:
            return r.status, r.read().decode()

    def _run(self):
        while not self._stop.is_set():
            try:
                for ep in SERVICE_ENDPOINTS:
                    self.codes.append((ep, self._get(ep)[0]))
                for t in self.tenants:
                    code, body = self._get(f"/picks/{t}?cursor={self.cursor[t]}&wait_s=0.2")
                    self.codes.append(("/picks", code))
                    for line in body.splitlines():
                        rec = json.loads(line)
                        self.lines[t].append(rec)
                        self.cursor[t] = rec["cursor"]
            except Exception as exc:  # noqa: BLE001 — reported by the phase
                self.errors.append(f"{type(exc).__name__}: {exc}")
                self._stop.wait(0.2)

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join(120)


@contextlib.contextmanager
def _latencies(slo_mod):
    """Keep every (tenant, seconds) the service observes into its
    ingest->pick-settled freshness histogram for the block."""
    orig = slo_mod.observe_pick_latency
    got = []

    def spy(tenant, latency_s):
        got.append((tenant, float(latency_s)))
        return orig(tenant, latency_s)

    slo_mod.observe_pick_latency = spy
    try:
        yield got
    finally:
        slo_mod.observe_pick_latency = orig


def _service_specs(service, files, sel, meta, mf_share, learned_share, design, **kw):
    common = dict(channels=sel, interrogator="silixa", metadata=meta.to_dict(),
                  batch=SERVICE_BATCH, slo_p95_s=SERVICE_SLO_S, linger_s=SERVICE_LINGER_S,
                  **kw)
    return [service.TenantSpec(name="mf", files=list(files), bucket="pow2",
                               hbm_share_gb=mf_share, detector_kwargs={"design": design},
                               **common),
            service.TenantSpec(name="learned", files=list(files), family="learned",
                               hbm_share_gb=learned_share, **common)]


def phase_service():
    """A ``DetectionService`` on the card with two tenants over the slab
    phase's four 22050 x 12000 TDMS files: ``mf`` (batch 4, pow2 buckets,
    health, a memory share between its measured B=2 and B=4 peaks, so
    admission pins it at ``batched:2`` before its first dispatch) and
    ``learned`` (the pretrained ``fin_cnn``, exact buckets, batch 4), both
    with an SLO target, quality and cost cards, a client polling every
    endpoint; and prepares ``python -m das4whales_tpu_torch serve
    --until-idle`` over ``SERVE_FILES`` file(s) a tenant, which
    :func:`serve_start` runs beside the next phases. Returns
    ``(launches, (picks_err, stft_err))``."""
    import dataclasses
    import shutil

    import torch

    from das4whales_tpu_torch import service
    from das4whales_tpu_torch.ops import fused_picks, fused_stft
    from das4whales_tpu_torch.ops import health as health_ops
    from das4whales_tpu_torch.telemetry import costs
    from das4whales_tpu_torch.telemetry import slo as slo_mod
    from das4whales_tpu_torch.utils import locks
    from das4whales_tpu_torch.utils.artifacts import read_records
    from das4whales_tpu_torch.utils.checkpoint import save_design
    from das4whales_tpu_torch.workflows import campaign as cmod

    t_phase = time.perf_counter()
    pre = _PREFLIGHT or phase_preflight()
    nx = CANONICAL[0]
    sel = [0, nx, 1]
    shared = slab_files()
    files = [p for p, (_, ns) in zip(shared["paths"], SLAB_FILES) if ns == CANONICAL[1]]
    scenes = dict(zip(shared["paths"], shared["scenes"]))
    meta = shared["scenes"][0].metadata
    design = _service_design(meta, nx)
    gib = 2**30
    mf_share = pre["budget"] / gib
    learned_share = SERVICE_LEARNED_SHARE * pre["peaks"][("learned", SERVICE_BATCH)].peak / gib
    d = shared["dir"] / "service"
    shutil.rmtree(d, ignore_errors=True)
    cfg = service.ServiceConfig(
        tenants=_service_specs(service, files, sel, meta, mf_share, learned_share, design),
        outdir=str(d), cost_cards=True, quality=True)
    costs.reset()
    locks.reset_order_graph()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    svc = service.DetectionService(cfg)
    zero_launches()                      # the service's main path starts here
    with _probes_marked() as probes, \
            _capture(fused_picks, "picks_cuda", skip=lambda: probes["active"]) as pcalls, \
            _capture(fused_stft, "stft_power_cuda", skip=lambda: probes["active"]) as scalls, \
            _timing(cmod, "_preflight_bucket") as admit_t, \
            _timing(health_ops, "host_health_stats") as health_t, \
            _latencies(slo_mod) as lats:
        t0 = time.perf_counter()
        svc.start()
        try:
            with _ServicePoller(svc.api.url, ("mf", "learned")) as poll:
                res = svc.run(until_idle=True)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                time.sleep(0.5)
        finally:
            svc.stop()
    launches = read_launches()
    if probes["n"]:
        # a probe resets the card's peak statistics: the peak below would
        # then cover only what ran after it
        fail(f"service: {probes['n']} memory probes ran in the service's window; its admission "
             "must price from the preflight phase's memoized probes")
    peak = torch.cuda.max_memory_allocated()
    inversions = locks.inversions()
    cards = costs.cards_payload()["cards"]
    # the contract gate's verdict rides each card (recorded on the
    # preflight phase's memoized probes: no program ran again for it)
    verdicts = {f"{c['program']} {c['bucket']} {c['engine']}": c["contract"] for c in cards}
    if not cards or set(verdicts.values()) != {"clean"}:
        fail(f"service: the cost cards' contract verdicts {verdicts} must all be clean: "
             f"{[c['contract_findings'] for c in cards]}")
    bad = [c for c in poll.codes if c[1] != 200]
    if poll.errors or bad or not poll.codes:
        fail(f"service: endpoints answered {bad[:5]}, errors {poll.errors[:3]} over "
             f"{len(poll.codes)} requests")
    if {ep for ep, _ in poll.codes} != set(SERVICE_ENDPOINTS) | {"/picks"}:
        fail(f"service: the client reached only {sorted({ep for ep, _ in poll.codes})}")
    for t in ("mf", "learned"):
        cur = [r["cursor"] for r in poll.lines[t]]
        if cur != list(range(1, len(cur) + 1)):
            fail(f"service: {t}'s NDJSON stream resumed out of order: cursors {cur}")
    if inversions:
        fail(f"service: lock-order inversions {inversions}")
    want_rung = {"mf": "batched:2", "learned": f"batched:{SERVICE_BATCH}"}
    for t, r in res.items():
        recs = [(x.status, x.rung) for x in r.records]
        if recs != [("done", want_rung[t])] * len(files):
            fail(f"service: tenant {t}: records {recs}")
    moves = [(e["from"], e["to"], e.get("preflight"), "admission" in e.get("error", ""))
             for e in read_records(str(d / "mf" / "manifest.jsonl"))
             if e.get("event") == "downshift"]
    if moves != [(f"batched:{SERVICE_BATCH}", "batched:2", True, True)]:
        fail(f"service: mf's downshift events {moves}; expected the admission's one pin")
    if any(e.get("event") == "downshift" for e in
           read_records(str(d / "learned" / "manifest.jsonl"))):
        fail("service: the learned tenant downshifted")
    if not peak < CARD_BYTES:
        fail(f"service: peak device memory {peak / gib:.2f} GiB")
    if launches["fused_picks"] == 0 or launches["fused_stft"] == 0:
        fail(f"service: launches {launches}; both kernels must run on the service route")
    tile = res_tile = min(512, nx)
    rows = {"first": 2 * 2 * res_tile, "last": 2 * 2 * (nx - (-(-nx // tile) - 1) * tile)}
    picks_err, picks_notes = _picks_at_main_path("service", pcalls, rows)
    stft_err, stft_rel, _ = _stft_at_main_path("service", scalls,
                                                (SERVICE_BATCH * nx, CANONICAL[1]))
    del pcalls, scalls
    # each tenant bitwise its standalone campaign at the same rung: the
    # preflight phase's batch-2 mf run and the learned phase's batched
    # campaign (run here when those phases did not run)
    std = {"mf": pre.get("mf_picks"), "learned": shared.get("learned_picks")}
    kw = dict(metadata=meta, interrogator="silixa")
    t0 = time.perf_counter()
    for t, extra in (("mf", dict(batch=2, design=design)),
                     ("learned", dict(batch=SERVICE_BATCH, family="learned"))):
        if std[t] is not None and set(files) <= set(std[t]):
            continue
        r = cmod.run_campaign_batched(files, sel, str(d / f"std_{t}"), **kw, **extra)
        if [(x.status, x.rung) for x in r.records] != [("done", want_rung[t])] * len(files):
            fail(f"service: {t}'s standalone campaign records "
                 f"{[(x.status, x.rung) for x in r.records]}")
        std[t] = _saved_picks(r)
    std_wall = time.perf_counter() - t0
    for t in ("mf", "learned"):
        _same_saved_picks(f"service: tenant {t}", res[t], std[t])
        for x in res[t].records:
            if _check_calls(scenes[x.path], cmod.load_picks(x.picks_file)):
                fail(f"service: tenant {t}: {os.path.basename(x.path)}: an injected call "
                     "was missed")
    lat = {t: [s for name, s in lats if name == t] for t in ("mf", "learned")}
    if any(len(v) != len(files) for v in lat.values()):
        fail(f"service: freshness samples {[(t, len(v)) for t, v in lat.items()]}")
    slo = svc.slo_report()
    del svc                              # free the tenants' device tensors for the child
    # the serve verb as a subprocess on the card
    sub_dir = shared["dir"] / "serve"
    shutil.rmtree(sub_dir, ignore_errors=True)
    sub_dir.mkdir()
    dpath = save_design(str(sub_dir / "design"), design)
    reg = {"outdir": str(sub_dir / "out"), "port": 0, "cost_cards": True, "quality": True,
           "tenants": [dataclasses.asdict(s) for s in _service_specs(
               service, files[:SERVE_FILES], sel, meta, mf_share, learned_share, dpath)]}
    reg_path = sub_dir / "registry.json"
    reg_path.write_text(json.dumps(reg))
    # the serve verb runs as a subprocess beside the fleet, dsp and
    # localize phases (serve_start / serve_finish; a cut for the run's time
    # limit)
    _SERVE.update(reg_path=reg_path, sub_dir=sub_dir, files=files[:SERVE_FILES])
    shutil.rmtree(d, ignore_errors=True)
    card_text = "; ".join(
        f"{c['program']} {c['bucket']} {c['engine']}: {c['flops'] / 1e12:.3f} Tops, "
        f"{c['bytes_accessed'] / 1e9:.2f} GB counted ({', '.join(c['stages'])}), peak "
        f"{c['peak_bytes'] / gib:.2f} GiB, first run {c['compile_seconds']:.3f} s, contract "
        f"{c['contract']}, roofline "
        + (f"{c['predicted_wall_s'] * 1e3:.2f} ms" if c["predicted_wall_s"] is not None
           else "none")
        for c in cards)
    per = {t: wall / len(files) for t in ("mf", "learned")}
    say(f"service: DetectionService on the card ({_SMI.get('line', 'nvidia-smi not read')}), tenants mf (batch "
        f"{SERVICE_BATCH}, pow2, health, share {mf_share:.2f} GiB) and learned (fin_cnn, exact, "
        f"batch {SERVICE_BATCH}, share {learned_share:.2f} GiB) over {len(files)} files of "
        f"{nx} x {CANONICAL[1]}: wall {wall:.2f} s ({per['mf']:.2f} s a file a tenant, both "
        f"tenants' passes sharing the card), record walls mf "
        f"{np.mean([x.wall_s for x in res['mf'].records]):.3f} / learned "
        f"{np.mean([x.wall_s for x in res['learned'].records]):.3f} s a file; admission's "
        f"pricing (after the pipe drained) {admit_t['s']:.3f} s over {admit_t['n']} buckets ({probes['n']} probes run here, "
        f"{probes['s']:.2f} s; the rest memoized from the preflight phase), mf pinned at "
        f"batched:2 before its first dispatch, learned at batched:{SERVICE_BATCH}; pick latency "
        f"p95 mf {np.percentile(lat['mf'], 95):.2f} s, learned "
        f"{np.percentile(lat['learned'], 95):.2f} s (SLO {SERVICE_SLO_S:.0f} s: "
        f"{[(r['tenant'], r['state']) for r in slo['tenants']]}); launches {launches}; "
        f"fused_picks bitwise its plain version at the route's first and last launch "
        f"({'; '.join(picks_notes)}), fused_stft within {stft_rel:.2e} * max; peak device "
        f"memory {peak / gib:.2f} GiB; {len(poll.codes)} requests over "
        f"{', '.join(SERVICE_ENDPOINTS)} and /picks (cursor resume: mf "
        f"{len(poll.lines['mf'])}, learned {len(poll.lines['learned'])} lines) all 200; 0 lock "
        f"inversions; each tenant's picks bitwise its standalone run_campaign_batched (the "
        f"preflight phase's batch-2 run, the learned phase's campaign; {std_wall:.1f} s here), "
        f"every injected call picked; host health stats of the learned tenant's slab "
        f"{health_t['s']:.2f} s over {health_t['n']} files; cost cards: {card_text}; "
        f"serve --until-idle subprocess over {SERVE_FILES} file(s) a tenant started beside "
        f"the next phases (its line below); phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches, (picks_err, stft_err)


#: the service phase's ``serve --until-idle`` subprocess: its registry, and
#: once started its process (serve_start / serve_finish)
_SERVE: dict = {}


def serve_start() -> None:
    """Start the service phase's ``serve --until-idle`` subprocess on the
    card, where that phase prepared one."""
    import gc
    import threading

    import torch

    if "reg_path" not in _SERVE or "proc" in _SERVE:
        return
    gc.collect()
    torch.cuda.empty_cache()
    _SERVE["t0"] = time.perf_counter()
    # its output goes to files: a pipe that nobody reads until the end
    # would stall the subprocess once full
    logs = [open(_SERVE["sub_dir"] / f"serve.{k}", "w") for k in ("out", "err")]
    _SERVE["proc"] = proc = subprocess.Popen(
        [sys.executable, "-m", "das4whales_tpu_torch", "serve", str(_SERVE["reg_path"]),
         "--until-idle"], cwd=str(_root_dir()), stdout=logs[0], stderr=logs[1],
        env=dict(os.environ, OMP_NUM_THREADS=str(BESIDE_THREADS)))
    for log in logs:
        log.close()

    def waiter():
        proc.wait()
        _SERVE["t_exit"] = time.perf_counter()

    threading.Thread(target=waiter, name="smoke-serve-wait", daemon=True).start()


def serve_finish() -> None:
    """Wait for the ``serve --until-idle`` subprocess: exit 0, both tenants'
    manifests settled over their files; its line; its files removed."""
    import shutil

    from das4whales_tpu_torch.workflows import campaign as cmod

    if "proc" not in _SERVE:
        return
    proc = _SERVE.pop("proc")
    t_wait = time.perf_counter()
    try:
        proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail("service: the serve subprocess outlived 600 s")
    t_wait = time.perf_counter() - t_wait
    sub_dir, files = _SERVE["sub_dir"], _SERVE["files"]
    out, err = ((sub_dir / f"serve.{k}").read_text() for k in ("out", "err"))
    serve_s = _SERVE.get("t_exit", time.perf_counter()) - _SERVE["t0"]
    if proc.returncode != 0:
        fail(f"service: the serve subprocess exited {proc.returncode}: {err[-3000:]}")
    for t in ("mf", "learned"):
        settled = cmod.load_settled(str(sub_dir / "out" / t))
        if sorted(settled) != sorted(files) or f"tenant {t}: {len(files)} done, 0 failed" \
                not in out:
            fail(f"service: the serve subprocess settled {sorted(settled)} for {t}: "
                 f"{out[-1000:]}")
    shutil.rmtree(sub_dir, ignore_errors=True)
    _SERVE.clear()
    say(f"service: serve --until-idle subprocess over {len(files)} file(s) a tenant, beside the "
        f"fleet phase: exit 0 in {serve_s:.1f} s, both manifests settled "
        f"(waited {t_wait:.1f} s for it here)")


#: the fleet drill: two workers on the one card and two live mf tenants
#: whose files the smoke pushes through the router's ``/ingest``. Every step
#: waits on state, never on a clock: a's first two files (one slab) are
#: pushed and a is migrated with them in flight (the drain resolves that
#: slab); b's first two settle on the worker a moved to; that worker, holding
#: both tenants and no unsettled file, is SIGKILLed; once the survivor owns
#: both, their last two files are pushed. Each slab is two files in the
#: campaign's order, so every slab is the standalone batch-2 campaign's (the
#: card's batched mode rounds by the slab it is given)
FLEET_WORKERS = 2
#: a worker's deadline to answer /livez (torch import, CUDA context)
FLEET_SPAWN_TIMEOUT_S = 180.0
#: the drill's deadline from the start to every file settled (a fault
#: bound: no step of the drill waits for a clock)
FLEET_SETTLE_TIMEOUT_S = 240.0


def _fleet_stream(url: str, tenant: str, n_expect: int, out: list, errors: list, stop) -> None:
    """A client's cursor stream through the router: long-poll
    ``/picks/<tenant>``, resume from the last cursor, retry a 503 (the
    migration window) and a refused connection."""
    import urllib.error
    import urllib.request

    cursor = 0
    while not stop.is_set():
        if sum(1 for r in out if r.get("status") == "done") >= n_expect:
            return
        try:
            with urllib.request.urlopen(f"{url}/picks/{tenant}?cursor={cursor}&wait_s=1",
                                        timeout=30) as r:
                body = r.read().decode()
        except urllib.error.HTTPError as exc:
            exc.read()
            if exc.code != 503:
                errors.append(f"/picks/{tenant}: HTTP {exc.code}")
                return
            stop.wait(0.2)
            continue
        except (urllib.error.URLError, OSError, TimeoutError):
            stop.wait(0.2)
            continue
        for line in body.splitlines():
            rec = json.loads(line)
            rec["_t"] = time.perf_counter()   # when the client saw it
            out.append(rec)
            cursor = rec["cursor"]


def _done_count(outdirs) -> int:
    from das4whales_tpu_torch.utils.artifacts import read_records

    return sum(1 for d in outdirs for r in read_records(os.path.join(d, "manifest.jsonl"))
               if r.get("status") == "done")


def _metric_by_worker(text: str, name: str) -> dict:
    """``{worker: sum}`` of a counter's samples in the router's
    worker-labelled exposition."""
    got: dict = {}
    for line in text.splitlines():
        if line.startswith(name + "{") and 'worker="' in line:
            w = line.split('worker="', 1)[1].split('"', 1)[0]
            got[w] = got.get(w, 0.0) + float(line.rsplit(" ", 1)[1])
    return got


def phase_fleet(svc_launches=None):
    """The self-healing fleet on the card: a ``FleetSupervisor`` in this
    process spawns two ``python -m das4whales_tpu_torch serve`` workers
    on the one H100, each with a memory share (``DAS_HBM_BUDGET_GB``)
    between the preflight phase's mf B=2 and B=4 peaks, and places two
    live mf tenants (``a``, ``b``: batch 2, pow2, its own outdir, a design
    checkpoint saved once) one a worker. The slab phase's four 22050 x
    12000 TDMS files are read as the replay source reads them and pushed
    to each tenant through the ``FleetRouter``'s ``/ingest``, named by
    their paths; a client streams both tenants' picks through the router
    with cursors. The drill (each step gated on state): a's first slab
    pushed, then one graceful migration of ``a`` onto ``b``'s worker with
    that slab in flight; once ``b``'s first slab settled, SIGKILL of that
    worker; the survivor adopts both from their manifests and takes their
    last two files. Checks: every file ``done`` exactly once fleet-wide,
    each tenant's picks bitwise the preflight phase's standalone batch-2
    campaign (whose first and last ``fused_picks`` launches that phase
    held bitwise against the plain version), the cursor streams gap- and
    duplicate-free, ``fsck_outdir`` clean and no tmp left, ``fleet.jsonl``
    replaying to the final assignment, the router's ``/fleet``,
    ``/metrics`` (worker-labelled), ``/livez`` and ``/readyz`` 200, the
    survivor's graceful exit 0 and no worker process left, and the
    service phase's 88 ``fused_picks`` launches. The workers' launches are
    not counted (they run in other processes, and this smoke adds no
    counter to the service); the phase prints the figure the workers'
    slab counters imply, one launch a channel tile of a slab."""
    import gc
    import shutil
    import signal
    import threading
    import urllib.request

    import torch

    from das4whales_tpu_torch.fleet import FleetConfig, FleetRouter, FleetSupervisor
    from das4whales_tpu_torch.fleet.supervisor import is_fleet_worker, settled_files
    from das4whales_tpu_torch.fsck import fsck_outdir
    from das4whales_tpu_torch.io.stream import stream_strain_blocks
    from das4whales_tpu_torch.utils import artifacts
    from das4whales_tpu_torch.utils.checkpoint import save_design
    from das4whales_tpu_torch.workflows.campaign import load_picks

    t_phase = time.perf_counter()
    if svc_launches is not None and svc_launches != 88:
        fail(f"fleet: the service phase launched fused_picks {svc_launches} times; 88 expected")
    pre = _PREFLIGHT or phase_preflight()
    nx = CANONICAL[0]
    sel = [0, nx, 1]
    shared = slab_files()
    files = [p for p, (_, ns) in zip(shared["paths"], SLAB_FILES) if ns == CANONICAL[1]]
    meta = shared["scenes"][0].metadata
    d = shared["dir"] / "fleet"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir()
    dpath = save_design(str(d / "design"), _service_design(meta, nx))
    share_gb = pre["budget"] / 2**30

    # each file's block as the replay source reads it (the tenant's
    # metadata, channels, interrogator and wire), pushed to both tenants
    t_read = time.perf_counter()
    blocks = []
    for b in stream_strain_blocks(files, sel, meta.to_dict(), interrogator="silixa",
                                  engine="h5py", as_numpy=True, wire="conditioned"):
        tr = np.ascontiguousarray(b.trace)
        blocks.append((tr.tobytes(), f"{tr.shape[0]},{tr.shape[1]}", tr.dtype.name))
        del b, tr
    read_s = time.perf_counter() - t_read

    def tenant(name):
        return {"name": name, "channels": sel, "batch": 2, "bucket": "pow2",
                "interrogator": "silixa", "metadata": meta.to_dict(),
                "linger_s": SERVICE_LINGER_S,
                "detector_kwargs": {"design": dpath, "channel_tile": pre["tile"]}}

    root = str(d / "root")
    cfg = FleetConfig(tenants=[tenant("a"), tenant("b")], root=root, workers=FLEET_WORKERS,
                      health_interval_s=0.25, probe_timeout_s=5.0, dead_after=3,
                      spawn_timeout_s=FLEET_SPAWN_TIMEOUT_S, drain_timeout_s=120.0,
                      worker_env={"DAS_HBM_BUDGET_GB": repr(share_gb),
                                  "PYTHONPATH": os.pathsep.join(filter(None, (
                                      os.path.dirname(os.path.abspath(__file__)),
                                      os.environ.get("PYTHONPATH"))))},
                      device="cuda")
    outdirs = {t: os.path.join(root, "tenants", t) for t in ("a", "b")}
    # the workers' contexts and shares come on top of what this process
    # holds: hand its cached blocks back first
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    sup = FleetSupervisor(cfg)
    stop = threading.Event()
    streams = {t: [] for t in outdirs}
    errors: list = []
    router = None
    push_s = []

    def push(t: str, i: int) -> None:
        body, shape, dtype = blocks[i]
        req = urllib.request.Request(
            f"{router.url}/ingest/{t}", data=body, method="POST",
            headers={"X-DAS-Shape": shape, "X-DAS-Dtype": dtype, "X-DAS-Name": files[i]})
        tp = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as r:
            code, text = r.status, r.read().decode()
        push_s.append(time.perf_counter() - tp)
        if code != 202:
            fail(f"fleet: /ingest/{t} of {os.path.basename(files[i])}: {code} {text}")

    try:
        t0 = time.perf_counter()
        sup.start()                       # returns once both workers answer /livez
        t_up = time.perf_counter()
        first = dict(sup.status()["assignments"])
        if sorted(first) != ["a", "b"] or first["a"] == first["b"]:
            fail(f"fleet: placement {first}; one tenant a worker expected")
        router = FleetRouter(sup, host=cfg.host, port=0).start()
        clients = [threading.Thread(target=_fleet_stream, name=f"smoke-stream-{t}",
                                    args=(router.url, t, len(files), streams[t], errors, stop),
                                    daemon=True) for t in outdirs]
        for c in clients:
            c.start()
        deadline = t0 + FLEET_SETTLE_TIMEOUT_S

        def await_(what, cond):
            while not cond():
                if time.perf_counter() > deadline:
                    fail(f"fleet: {what}: {sup.status()}")
                time.sleep(0.05)

        # each tenant's first slab; a is migrated with its slab in flight
        for t in ("a", "b"):
            push(t, 0)
            push(t, 1)
        tm = time.perf_counter()
        mig = sup.migrate("a", trigger="rebalance")
        mig_s = time.perf_counter() - tm
        dst = mig["dst"]
        if dst != first["b"]:
            fail(f"fleet: a migrated to {dst}, not to b's worker {first['b']}")
        if sorted(settled_files(outdirs["a"])) != files[:2]:
            fail(f"fleet: a's drain settled {sorted(settled_files(outdirs['a']))}; its "
                 "in-flight first slab and nothing else")
        await_("b's first slab did not settle", lambda: len(settled_files(outdirs["b"])) >= 2)
        t_first = time.perf_counter()
        # the victim holds both tenants and no file that is not settled
        if any(sorted(settled_files(o)) != files[:2] for o in outdirs.values()):
            fail(f"fleet: settled before the kill "
                 f"{[sorted(map(os.path.basename, settled_files(o))) for o in outdirs.values()]}")
        with urllib.request.urlopen(router.url + "/metrics", timeout=30) as r:
            text = r.read().decode()
        slabs_before = _metric_by_worker(text, "das_service_slabs_total")
        mem_before = {g: _metric_by_worker(text, g) for g in
                      ("das_preflight_hbm_peak_bytes", "das_hbm_bytes_in_use")}
        victim = next(w for w in sup.workers() if w.name == dst)
        survivor = next(w.name for w in sup.workers() if w.name != dst)
        done_before = _done_count(outdirs.values())
        tk = time.perf_counter()
        os.kill(victim.pid, signal.SIGKILL)
        await_("the survivor did not adopt both tenants", lambda: all(
            (w := sup.owner(t)) is not None and w.name == survivor for t in outdirs))
        t_adopted = time.perf_counter()
        for t in ("a", "b"):
            push(t, 2)
            push(t, 3)
        t_pushed = time.perf_counter()
        await_("no file settled after the SIGKILL",
               lambda: _done_count(outdirs.values()) > done_before)
        t_done = time.perf_counter()
        await_("not every file settled", lambda: all(
            set(files) <= settled_files(o) for o in outdirs.values()))
        t_settled = time.perf_counter()
        for c in clients:
            c.join(60)
        codes = {}
        for path in ("/fleet", "/metrics", "/livez", "/readyz"):
            with urllib.request.urlopen(router.url + path, timeout=30) as r:
                codes[path] = (r.status, r.read().decode())
        final_status = sup.status()
    finally:
        if router is not None:
            router.stop()
        sup.stop()
        stop.set()
    t_stopped = time.perf_counter()
    push_gib = len(blocks[0][0]) / 2**30
    del blocks
    if errors:
        fail(f"fleet: the cursor streams failed: {errors}")
    if {p: c for p, (c, _) in codes.items()} != dict.fromkeys(codes, 200):
        fail(f"fleet: router answers {[(p, c) for p, (c, _) in codes.items()]}")
    metrics_text = codes["/metrics"][1]
    if f'worker="{survivor}"' not in metrics_text or "das_fleet_migrations_total" not in metrics_text:
        fail("fleet: the router's /metrics lacks the worker-labelled samples or the fleet's own")
    slabs_after = _metric_by_worker(metrics_text, "das_service_slabs_total")
    mem_after = {g: _metric_by_worker(metrics_text, g) for g in mem_before}
    mem_text = "; ".join(
        f"{g} {', '.join(f'{w} {v / 2**30:.2f} GiB' for w, v in sorted(m.items()))} before the "
        f"kill, {', '.join(f'{w} {v / 2**30:.2f} GiB' for w, v in sorted(mem_after[g].items()))} "
        "at the end" for g, m in mem_before.items())
    done_t = {t: [round(r["_t"] - t0, 1) for r in streams[t] if r.get("status") == "done"]
              for t in streams}
    rcs = {w.name: w.proc.returncode for w in sup.workers()}
    if any(rc is None for rc in rcs.values()) or rcs[survivor] != 0:
        fail(f"fleet: worker exit codes {rcs}; the survivor must drain and exit 0")
    alive = []
    for pid in os.listdir("/proc"):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                cmd = fh.read()
            with open(f"/proc/{pid}/stat", "rb") as fh:
                state = fh.read().rsplit(b")", 1)[-1].split()[0]
        except (OSError, ValueError):
            continue
        if state != b"Z" and is_fleet_worker(cmd, root):
            alive.append(int(pid))
    if alive:
        fail(f"fleet: worker processes still running after stop: {alive}")
    ref = pre["mf_picks"]
    for t, o in outdirs.items():
        done = {}
        for r in artifacts.read_records(os.path.join(o, "manifest.jsonl")):
            if r.get("status") == "done":
                done.setdefault(r["path"], []).append(r)
        if sorted(done) != sorted(files) or any(len(v) != 1 for v in done.values()):
            fail(f"fleet: tenant {t}: done records {[(os.path.basename(p), len(v)) for p, v in done.items()]}")
        for path, (r,) in done.items():
            if r.get("rung") != "batched:2":
                fail(f"fleet: tenant {t}: {os.path.basename(path)} at {r.get('rung')}")
            got, want = load_picks(r["picks_file"]), ref[path]
            if set(got) != set(want) or any(not np.array_equal(got[k], want[k]) for k in got):
                fail(f"fleet: tenant {t}: {os.path.basename(path)}: picks differ from the "
                     "standalone batch-2 campaign's")
        findings = fsck_outdir(o)
        if findings:
            fail(f"fleet: fsck_outdir {t}: {[f.as_dict() for f in findings]}")
        cur = [r["cursor"] for r in streams[t]]
        seen = [r["path"] for r in streams[t] if r.get("status") == "done"]
        if cur != list(range(1, len(cur) + 1)) or sorted(seen) != sorted(files):
            fail(f"fleet: tenant {t}'s cursor stream: cursors {cur}, done {len(seen)}")
    tmps = artifacts.sweep_orphan_tmps(root, remove=False)
    if tmps:
        fail(f"fleet: tmp files left {tmps}")
    ledger = artifacts.read_records(os.path.join(root, "fleet.jsonl"))
    replay = {}
    for r in ledger:
        if r.get("event") == "assign":
            replay[r["tenant"]] = r["worker"]
    if replay != final_status["assignments"] or set(replay.values()) != {survivor}:
        fail(f"fleet: fleet.jsonl replays to {replay}; final {final_status['assignments']}")
    triggers = sorted(r["trigger"] for r in ledger if r.get("event") == "migrate")
    if not any(r.get("event") == "dead" and r["worker"] == dst for r in ledger) \
            or set(triggers) != {"rebalance", "failure"}:
        fail(f"fleet: ledger migrations {triggers}, dead events "
             f"{[r for r in ledger if r.get('event') == 'dead']}")
    walls = {t: [r.get("wall_s") for r in artifacts.read_records(os.path.join(o, "manifest.jsonl"))
                 if r.get("status") == "done"] for t, o in outdirs.items()}
    # the victim's slabs as read before the kill, the survivor's at the end
    slabs = slabs_before.get(dst, 0.0) + slabs_after.get(survivor, 0.0)
    per_slab = -(-nx // pre["tile"])          # one launch a channel tile
    say(f"fleet: FleetSupervisor + FleetRouter on the card ({_SMI.get('line', 'nvidia-smi not read')}), "
        f"{FLEET_WORKERS} serve workers (share DAS_HBM_BUDGET_GB={share_gb:.2f}, between the "
        f"mf B=2 and B=4 peaks), live tenants a and b (mf, batch 2, pow2, one design "
        f"checkpoint), each fed the {len(files)} files of {nx} x {CANONICAL[1]} through the "
        f"router's /ingest (read {read_s:.1f} s; {len(push_s)} pushes of "
        f"{push_gib:.2f} GiB, "
        f"{min(push_s):.2f}-{max(push_s):.2f} s each): fleet up (both workers spawned and "
        f"answering /livez, both tenants adopted) {t_up - t0:.1f} s, placement {first}; "
        f"graceful migration of a ({mig['src']} -> {dst}) with its first slab in flight "
        f"{mig_s:.2f} s (the drain waits for the slab); both first slabs settled at "
        f"{t_first - t0:.1f} s; SIGKILL of {dst} (pid {victim.pid}, both tenants, nothing "
        f"unsettled): both adopted by {survivor} after {t_adopted - tk:.2f} s, the last two "
        f"files of each pushed {t_pushed - tk:.1f} s after the kill, the survivor's first done "
        f"{t_done - tk:.1f} s after it, every file settled {t_settled - tk:.1f} s after it; "
        f"record walls a file a {np.mean(walls['a']):.3f} / b {np.mean(walls['b']):.3f} s, "
        f"the pass {(t_settled - t_up) / len(files):.1f} s a file a tenant; each tenant's "
        f"{len(files)} files done once at batched:2, picks bitwise the preflight phase's "
        f"standalone batch-2 campaign, whose first and last fused_picks launches that phase "
        f"held bitwise against the plain version; cursor streams a {len(streams['a'])} / b "
        f"{len(streams['b'])} lines, gap- and duplicate-free; fsck_outdir clean, no tmp "
        f"left; fleet.jsonl replays to {replay}; router /fleet /metrics /livez /readyz 200; "
        f"slabs resolved by worker (das_service_slabs_total) before the kill "
        f"{slabs_before}, at the end {slabs_after}: {int(per_slab * slabs)} fused_picks "
        f"launches implied at {per_slab} a slab (not counted: the workers are other "
        f"processes); worker exit "
        f"codes {rcs} (the killed one {victim.proc.returncode}), none left running; each "
        f"worker's device memory from its /metrics: {mem_text}; this process's peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; the clients saw each done "
        f"record at (s from the start) {done_t}; stop {t_stopped - t_settled:.1f} s; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    shutil.rmtree(d, ignore_errors=True)


@contextlib.contextmanager
def _learned_slab_scores(probes):
    """Keep the scores every ``BatchedLearnedDetector`` slab reads back
    (``_fetch``: ``[n, C, n_win]`` on the host) for the block, by device
    type, in slab order; a memory probe's (``probes["active"]``) are not
    kept."""
    from das4whales_tpu_torch.parallel.batch import BatchedLearnedDetector

    orig = BatchedLearnedDetector._fetch
    got: dict = {}

    def spy(self, heavy):
        out = orig(self, heavy)
        if not probes["active"]:
            got.setdefault(self.det.device.type, []).append(np.array(out))
        return out

    BatchedLearnedDetector._fetch = spy
    try:
        yield got
    finally:
        BatchedLearnedDetector._fetch = orig


def phase_service_cpu_vs_card():
    """The same two-tenant service at 512 x 12000 on the card and with
    ``device="cpu"``: manifests equal record for record (status, rung,
    attempts), the mf picks equal up to knife edges, the scores the
    learned tenant's own slabs read back within ``LEARNED_CARD_ABS`` and
    its picks up to knife edges of the CPU service's scores."""
    import shutil
    import tempfile
    from pathlib import Path

    from das4whales_tpu_torch import service
    from das4whales_tpu_torch.io.stream import stream_batched_slabs
    from das4whales_tpu_torch.models.learned import load_pretrained, window_centers
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.utils.checkpoint import save_design
    from das4whales_tpu_torch.workflows import campaign as cmod

    t_phase = time.perf_counter()
    nx = 512
    sel = [0, nx, 1]
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    d = Path(tempfile.mkdtemp(prefix="service_cpu_files_", dir=root))
    try:
        files, scenes_l, _ = _write_files(d, SERVICE_CPU_FILES, nx, n_calls=1)
        scenes = dict(zip(files, scenes_l))
        meta = scenes_l[0].metadata
        design = MatchedFilterDetector(meta, sel, (nx, SLAB_BUCKET), device="cpu").design
        dpath = save_design(str(d / "design_16384"), design)
        res, walls = {}, {}
        with _probes_marked() as probes, _learned_slab_scores(probes) as slab_scores:
            for dev in ("cuda", "cpu"):
                svc = service.DetectionService(service.ServiceConfig(
                    tenants=_service_specs(service, files, sel, meta, None, None, dpath),
                    outdir=str(d / f"svc_{dev}"), device=dev, cost_cards=True, quality=True))
                svc.start()
                t0 = time.perf_counter()
                try:
                    res[dev] = svc.run(until_idle=True)
                finally:
                    svc.stop()
                walls[dev] = time.perf_counter() - t0
        for t in ("mf", "learned"):
            a = [(os.path.basename(r.path), r.status, r.rung, r.attempts)
                 for r in res["cuda"][t].records]
            b = [(os.path.basename(r.path), r.status, r.rung, r.attempts)
                 for r in res["cpu"][t].records]
            if a != b or {r[1] for r in a} != {"done"}:
                fail(f"service_cpu_vs_card: tenant {t}: records card {a} vs cpu {b}")
        blocks = {}
        for slab in stream_batched_slabs(files, sel, meta, batch=1, bucket="pow2",
                                         as_numpy=True, interrogator="silixa"):
            blocks[slab.paths[0]] = slab.stack[0]
        cpu_det = MatchedFilterDetector.from_design(design, meta, device="cpu")
        n_mf = _compare_campaigns("service_cpu_vs_card: mf", res["cuda"]["mf"],
                                  res["cpu"]["mf"], cpu_det, blocks, scenes)
        # the learned tenant's own scores, its slabs in file order on each device
        scores = {dev: np.concatenate(slab_scores.get(dev, [np.zeros((0,))]), axis=0)
                  for dev in ("cuda", "cpu")}
        n_files = len(res["cpu"]["learned"].records)
        if scores["cuda"].shape != scores["cpu"].shape or len(scores["cpu"]) != n_files:
            fail(f"service_cpu_vs_card: the learned tenant's slab scores card "
                 f"{scores['cuda'].shape} vs cpu {scores['cpu'].shape} for {n_files} files")
        e_scores = float(np.abs(scores["cuda"] - scores["cpu"]).max())
        if not e_scores <= LEARNED_CARD_ABS:
            fail(f"service_cpu_vs_card: the learned tenant's scores {e_scores:.3e} apart (limit "
                 f"{LEARNED_CARD_ABS})")
        centers = window_centers(scores["cpu"].shape[-1], load_pretrained()[1])
        n_learned = 0
        for i, (ra, rb) in enumerate(zip(res["cuda"]["learned"].records,
                                         res["cpu"]["learned"].records)):
            pa, pb = cmod.load_picks(ra.picks_file), cmod.load_picks(rb.picks_file)
            n_learned += _learned_knife("service_cpu_vs_card: learned", pa["CALL"], pb["CALL"],
                                        scores["cpu"][i], centers, 0.5)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    say(f"service_cpu_vs_card: the two-tenant service (mf batch {SERVICE_BATCH} pow2 on one "
        f"design, learned batch {SERVICE_BATCH}) over {len(files)} files of {nx} x "
        f"{CANONICAL[1]} on the card ({walls['cuda']:.1f} s) and on the CPU "
        f"({walls['cpu']:.1f} s): records equal (status, rung, attempts), every file done; "
        f"mf picks {n_mf} differing (knife edges), every injected call picked; the learned "
        f"tenant's own slab scores ({len(slab_scores['cuda'])} card and "
        f"{len(slab_scores['cpu'])} CPU slabs) within {e_scores:.2e} (limit "
        f"{LEARNED_CARD_ABS}), picks {n_learned} differing (knife edges of the CPU service's "
        f"scores); phase {time.perf_counter() - t_phase:.1f} s")



#: the matmul engines the ``mxu`` phase drives through ``detect_picks``,
#: by label: forced engines, and "auto" for both stages (the calibrated
#: routers on the phase's own table)
MXU_ENGINES = (("matmul", {"mf_engine": "matmul"}),
               ("matmul+fk", {"mf_engine": "matmul", "fk_engine": "matmul"}),
               ("matmul-bf16", {"mf_engine": "matmul-bf16"}),
               ("matmul-fused", {"mf_engine": "matmul-fused"}),
               ("auto", {"mf_engine": "auto", "fk_engine": "auto"}))
#: the f-k calibration's channel count below the auto router's cap
MXU_FK_CHANNELS = 4096
#: the STFT calibration's shape: the spectro family's chunk
MXU_STFT = (4096, 12000, 160, 8)
#: a float32 engine's envelopes against the FFT route's (``mxu``) and its
#: correlograms card against CPU (``mxu_cpu_vs_card``), of their max
MXU_CARD_REL = 1e-4
#: a float32 engine's thresholds against the reference route's (rtol); the
#: tap-folded engine's linear bandpass is not the FFT route's circular one,
#: so its thresholds get the CPU tests' 1e-4
MXU_THR_RTOL = 1e-5
MXU_FUSED_THR_RTOL = 1e-4
#: the knife-edge margin of a float32 engine's picks (of the threshold)
MXU_KNIFE_REL = 1e-5
#: the bf16 route against the FFT route, of max: every product of two
#: bf16-rounded inputs carries at most 2u = 2**-7 of relative rounding
#: (u = 2**-8, bf16's unit roundoff); also its thresholds' rtol
MXU_BF16_REL = 2.0 ** -7
#: the bf16 route card against CPU, of max: the two filtered blocks part in
#: the last float32 bits, which moves a few inputs to the neighbouring bf16
#: value; 1e-3 is an eighth of a bf16 ulp at the max (2**-7), and holds the
#: thresholds (rtol) as well
MXU_CARD_BF16_REL = 1e-3


@contextlib.contextmanager
def _mxu_table():
    """A calibration table of the run's own (``DAS_CALIBRATION_CACHE`` in
    a temporary directory), and a count of the A/B measurements made."""
    import shutil
    import tempfile

    from das4whales_tpu_torch.ops import mxu

    d = tempfile.mkdtemp(prefix="mxu_table_")
    prev = os.environ.get("DAS_CALIBRATION_CACHE")
    os.environ["DAS_CALIBRATION_CACHE"] = os.path.join(d, "calibration.json")
    best, counted = mxu._best_wall, {"n": 0}

    def counting(*a, **kw):
        counted["n"] += 1
        return best(*a, **kw)

    mxu._best_wall = counting
    try:
        yield counted
    finally:
        mxu._best_wall = best
        if prev is None:
            os.environ.pop("DAS_CALIBRATION_CACHE", None)
        else:
            os.environ["DAS_CALIBRATION_CACHE"] = prev
        shutil.rmtree(d, ignore_errors=True)


def _engine_filter(det, x, engine: str):
    """``(trf, fused pair, FIR half-length)``: the block filtered as
    ``det``'s one-program route filters it for the correlate ``engine``."""
    from das4whales_tpu_torch.models.matched_filter import mf_filter_fused, mf_filter_only

    mask, staged, kw = det._program_inputs()
    fused, fir_half = kw["mf_fused"], kw["fir_half"]
    if engine == "matmul-fused" and det.mf_engine != "matmul-fused":
        # the fold forced through where the detector's gate refused it: the
        # gainless mask, no staged bandpass, the detector's own FIR folded
        import torch

        from das4whales_tpu_torch.ops import fk as fk_ops

        mask = torch.as_tensor(fk_ops.banded_mask_half(det.design.fk_mask)[0],
                               device=det.device)
        staged = False
        fused, fir_half = det._fused_tap_arrays(det._templates_true)
    xin = det.condition_input(x)
    if staged:
        trf = mf_filter_only(xin, mask, det._bp_gain, det._band_lo, det._band_hi,
                             det.design.bp_padlen, det.fk_pad_rows, det.fk_engine, kw["fk_dft"])
    else:
        trf = mf_filter_fused(xin, mask, det._band_lo, det._band_hi, det.fk_pad_rows,
                              det.fk_engine, kw["fk_dft"])
    return trf, fused, fir_half


def _engine_corr(det, x, engine: str | None = None, trf=None):
    """The correlograms ``[nT, C, T]`` the detector's one-program route
    picks on, untiled, on its engines (or on the correlate ``engine``);
    ``trf`` takes an already filtered block instead of filtering ``x``."""
    from das4whales_tpu_torch.ops import mxu

    engine = engine or det.mf_engine
    got, fused, fir_half = _engine_filter(det, x, engine)
    if trf is not None:
        got = trf.to(det.device)
    return mxu.correlograms_body(got, det._templates_true, det._template_mu,
                                 det._template_scale, engine, fused=fused, fir_half=fir_half)


def _bf16_knife_rel(bound: float, scale: float, thr: float, thr_rtol: float) -> float:
    """The bf16 route's knife-edge margin, of the threshold, from its fixed
    bounds: an envelope held within ``bound * scale`` moves a height, a
    neighbour's tie or a prominence by at most twice that, and the
    threshold moves by ``thr_rtol``."""
    return 2.0 * bound * scale / abs(thr) + thr_rtol


def phase_mxu(scene=None, raw=None, design=None):
    """The matmul engines on the canonical block: each calibration's
    seconds and verdict, the two precision gates, ``detect_picks`` on
    every engine beside the FFT route (median of 3 after a warm-up, stage
    walls, launches, reads, peak, the pick kernel bitwise its plain
    version at the route's first and last launch, every call picked,
    picks up to knife edges of the FFT route's), the full route on
    ``matmul``, the batched facade at [4, 22050, 16384] on ``matmul``, and
    a second ``auto`` detector on the same table measuring nothing."""
    import torch

    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.ops import fk as fk_ops
    from das4whales_tpu_torch.ops import fused_picks, fused_stft, mxu, spectral, xcorr
    from das4whales_tpu_torch.ops.filters import butter_zero_phase_fir, butter_zero_phase_gain
    from das4whales_tpu_torch.parallel.batch import BatchedMatchedFilterDetector, trim_picks
    from das4whales_tpu_torch.utils.parity import envelopes, unexplained_differences

    t_phase = time.perf_counter()
    if design is None:
        scene, raw, design = _canonical_inputs()
    nx, ns = raw.shape
    meta = scene.metadata
    tt, mu, sc = xcorr.padded_template_stats(design.templates)
    nT, m = tt.shape
    fir, L = butter_zero_phase_fir(design.fs, design.bp_band, order=design.bp_order)
    gain_n = butter_zero_phase_gain(ns, design.fs, design.bp_band, order=design.bp_order)
    _, lo, hi = fk_ops.banded_mask_half(design.fk_mask)
    x = torch.as_tensor(raw).to("cuda")
    n_tiles = -(-nx // 512)
    last_rows = nT * (nx - (n_tiles - 1) * 512)
    notes, out = [], {"launches": 0, "err": 0.0, "stft_err": 0.0, "stft_launches": 0}
    with _mxu_table() as measured:
        # -- the calibrations and gates at the canonical shape
        cal = {}

        def calib(name, fn):
            t0 = time.perf_counter()
            entry = fn()
            cal[name] = {**entry, "seconds": round(time.perf_counter() - t0, 3)}

        calib("correlate", lambda: mxu.calibrate_correlate(nx, ns, m, nT, device="cuda"))
        calib("correlate-fused",
              lambda: mxu.calibrate_correlate_fused(nx, ns, m, nT, L, device="cuda"))
        calib(f"fk@{MXU_FK_CHANNELS}",
              lambda: mxu.calibrate_fk(MXU_FK_CHANNELS, ns, 0, hi - lo, device="cuda"))
        C_s, T_s, nfft, hop = MXU_STFT
        with _capture(fused_stft, "stft_power_cuda") as stft_calls:
            calib("stft", lambda: mxu.calibrate_stft(C_s, T_s, nfft, hop, device="cuda"))
        if stft_calls["n"] == 0:
            fail("mxu: calibrate_stft did not launch fused_stft as its 'fused' candidate")
        out["stft_launches"] = stft_calls["n"]
        out["stft_err"], stft_rel, _ = _stft_at_main_path(
            "mxu calibrate_stft", stft_calls, (min(C_s, 2048), T_s))
        fk_wide = mxu.resolve_fk_engine("auto", nx, ns, hi - lo, device="cuda")
        if fk_wide[0] != "fft" or "above DAS_FK_MATMUL_MAX_CHANNELS" not in fk_wide[1]:
            fail(f"mxu: fk_engine='auto' at {nx} channels resolved {fk_wide}")
        t0 = time.perf_counter()
        gates = {"bf16": mxu.bf16_correlate_gate((nx, ns), tt, mu, sc, device="cuda"),
                 "fused": mxu.fused_correlate_gate((nx, ns), tt, mu, sc, fir, gain_n,
                                                   device="cuda")}
        t_gates = time.perf_counter() - t0
        xs = torch.randn((C_s, T_s), device="cuda")
        stft_mm_ms = _cuda_ms(lambda: spectral.stft_magnitude(xs, nfft, hop, engine="matmul"),
                              5)
        del xs
        say(f"mxu: calibrations at {nx}x{ns} (A/B at {min(nx, 2048)} rows; seconds include "
            f"the warm-ups; f-k band {hi - lo} rfft bins, templates m={m} T={nT}, FIR "
            f"half-length L={L}) {json.dumps(cal)}; fk auto at {nx}: {fk_wide}; gates "
            f"({t_gates:.2f} s): {json.dumps(gates)}; fused_stft launched "
            f"{stft_calls['n']} times as the stft 'fused' candidate, within "
            f"{stft_rel:.2e}*max of plain; the matmul STFT at {C_s}x{T_s} nfft {nfft} hop "
            f"{hop}: {stft_mm_ms:.4f} ms a call (CUDA events)")

        # -- detect_picks on the FFT route and on every engine
        def build(engines):
            t0 = time.perf_counter()
            det = MatchedFilterDetector.from_design(design, meta, templates="fin", wire="raw",
                                                    pick_mode="sparse", **engines)
            return det, time.perf_counter() - t0

        fft_det, _ = build({"mf_engine": "fft", "fk_engine": "fft"})
        fft_env = envelopes(fft_det, x)
        fft_env_dev = torch.as_tensor(fft_env, device="cuda")   # the bounds, on the card
        scale = float(fft_env.max())
        rows = {}
        for label, engines in (("fft", {"mf_engine": "fft", "fk_engine": "fft"}),) + MXU_ENGINES:
            det, t_build = (fft_det, 0.0) if label == "fft" else build(engines)
            with _capture(fused_picks, "picks_cuda") as calls:
                det.detect_picks(x)              # warm-up: cuDNN's choice, cuFFT plans
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_launches()                      # the main path's runs start here
            det.syncs = det.dispatches = det.escalations = 0
            walls, stages, deltas, res = _timed_runs(
                lambda hook: det.detect_picks(x, stage_hook=hook),
                {"launches": lambda: fused_picks.launches, "syncs": lambda: det.syncs,
                 "attempts": lambda: det.dispatches})
            launches = read_launches()["fused_picks"]
            peak = torch.cuda.max_memory_allocated()
            for k, d in enumerate(deltas):
                if d["launches"] != n_tiles * d["attempts"]:
                    fail(f"mxu: {label} run {k} launched fused_picks {d['launches']} times in "
                         f"{d['attempts']} attempts, expected {n_tiles} each")
                if d["syncs"] not in (d["attempts"], d["attempts"] + 1):
                    fail(f"mxu: {label} run {k} made {d['syncs']} reads for {d['attempts']} "
                         "attempts")
            misses = _check_calls(scene, res.picks)
            if misses:
                fail(f"mxu: {label}: injected calls not picked: {misses}")
            err, pk_notes = _picks_at_main_path(f"mxu {label}", calls,
                                                {"first": 2 * 512, "last": last_rows})
            out["err"] = max(out["err"], err)
            if label != "fft":
                out["launches"] += launches
            row = {"engines": f"{det.mf_engine}/{det.fk_engine}",
                   "reason": det.mf_engine_reason if label != "auto"
                   else f"{det.mf_engine_reason} | fk: {det.fk_engine_reason}",
                   "wall_ms": round(statistics.median(walls) * 1e3, 3),
                   "stages_ms": _median_stages(stages), "launches": launches,
                   "reads": [d["syncs"] for d in deltas], "peak_gib": round(peak / 2**30, 2),
                   "build_s": round(t_build, 2)}
            if label == "fft":
                ref = res
            else:
                corr = _engine_corr(det, x)
                if corr.dtype != torch.float32:
                    fail(f"mxu: {label}: the {det.mf_engine} route returned {corr.dtype}")
                if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
                    fail(f"mxu: {label}: TF32 left on after the run")
                env_dev = spectral.envelope_sqrt(corr)
                del corr
                edge = det._mf_fir_half if det.mf_engine == "matmul-fused" else 0
                bf16 = det.mf_engine == "matmul-bf16"
                env_lim = MXU_BF16_REL if bf16 else MXU_CARD_REL
                thr_rtol = (MXU_BF16_REL if bf16 else
                            MXU_FUSED_THR_RTOL if edge else MXU_THR_RTOL)
                env_err = float((env_dev[..., edge:ns - edge]
                                 - fft_env_dev[..., edge:ns - edge]).abs().max())
                if not env_err <= env_lim * scale:
                    fail(f"mxu: {label}: envelopes differ from the FFT route's by "
                         f"{env_err / scale:.3e} of max (limit {env_lim:.3e})")
                n_edge, n_diff, rels, thr_rel = 0, 0, {}, {}
                for i, name in enumerate(ref.picks):
                    thr = ref.thresholds[name]
                    thr_rel[name] = float(f"{abs(res.thresholds[name] / thr - 1):.3g}")
                    if not np.isclose(res.thresholds[name], thr, rtol=thr_rtol, atol=0):
                        fail(f"mxu: {label}: {name} threshold {res.thresholds[name]} against "
                             f"the FFT route's {thr} (rtol {thr_rtol:.3g})")
                    rel = (_bf16_knife_rel(env_lim, scale, thr, thr_rtol) if bf16
                           else MXU_KNIFE_REL)
                    rels[name] = float(f"{rel:.3g}")
                    a, b = ref.picks[name], res.picks[name]
                    keep = [(p[1] >= edge) & (p[1] < ns - edge) for p in (a, b)]
                    n_edge += int((~keep[0]).sum() + (~keep[1]).sum())
                    a, b = a[:, keep[0]], b[:, keep[1]]
                    bad = unexplained_differences(a, b, fft_env[i], thr, rel)
                    if bad:                      # this route's own envelopes may explain them
                        bad = [p for p in bad if p in unexplained_differences(
                            a, b, env_dev[i].cpu().numpy(), thr, rel)]
                    if bad:
                        fail(f"mxu: {label}: {name} picks differ from the FFT route beyond "
                             f"knife edges (rel {rel:.3g}) at {bad[:10]}")
                    n_diff += len({tuple(p) for p in a.T.tolist()}
                                  ^ {tuple(p) for p in b.T.tolist()})
                del env_dev
                row.update({"env_rel": float(f"{env_err / scale:.3g}"), "env_limit": env_lim,
                            "differing_picks": n_diff, "knife_rel": rels,
                            "thresholds_rel": thr_rel, "thresholds_rtol": thr_rtol})
                if edge:
                    row["picks_within_L_of_the_ends"] = n_edge
            rows[label] = row
            notes.append(f"{label}: {'; '.join(pk_notes[:2])}")
            if label == "matmul":
                mm_det = det
            elif label == "auto":
                auto_det = det
            else:
                del det
        del fft_env, fft_env_dev
        say(f"mxu: detect_picks {nx}x{ns} raw int32, fin (T={nT}, m={m}), {n_tiles} tiles; "
            f"per engine {json.dumps(rows)}; pick kernel bitwise plain at each route's first "
            f"and last launch ({' | '.join(notes)})")

        # -- the full route on matmul once (tiled: the route of the canonical
        # block, where the correlate runs on the detector's engine)
        mm_det = mm_det.tiled_view()
        zero_launches()
        mm_det.syncs = mm_det.escalations = 0
        timer = StageTimer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full = mm_det(x, stage_hook=timer)
        torch.cuda.synchronize()
        t_full = time.perf_counter() - t0
        full_launches = read_launches()["fused_picks"]
        out["launches"] += full_launches
        if full_launches != n_tiles * (1 + mm_det.escalations):
            fail(f"mxu: the full route launched fused_picks {full_launches} times")
        again = mm_det.detect_picks(x)
        for name in again.picks:
            if not np.array_equal(full.picks[name], again.picks[name]) \
                    or full.thresholds[name] != again.thresholds[name]:
                fail(f"mxu: the full route's {name} picks or threshold differ from "
                     "detect_picks' on the same matmul detector")
        if not all(bool(torch.isfinite(c).all()) for c in full.correlograms.values()):
            fail("mxu: the full route's correlograms are not finite")
        del full, again

        # -- a second auto detector on the same table measures nothing
        before = measured["n"]
        second, _ = build({"mf_engine": "auto", "fk_engine": "auto"})
        if measured["n"] != before or (second.mf_engine, second.fk_engine) != (
                auto_det.mf_engine, auto_det.fk_engine):
            fail(f"mxu: a second auto detector made {measured['n'] - before} measurements "
                 f"and resolved {second.mf_engine}/{second.fk_engine}")
        del second, auto_det

        # -- the batched facade at [4, 22050, 16384] on matmul
        design16 = _service_design(meta, nx)
        det16 = MatchedFilterDetector.from_design(design16, meta, templates="fin",
                                                  mf_engine="matmul")
        cond = torch.as_tensor(_condition_on_host(raw, float(np.float32(meta.scale_factor))))
        facade = None
        for B in (4, 2, 1):
            stack = None
            try:
                stack = torch.zeros((B, nx, SLAB_BUCKET), device="cuda")
                stack[:, :, :ns] = cond.to("cuda")
                bd = BatchedMatchedFilterDetector(det16, serial=False)
                bd.detect_batch(stack, n_real=[ns] * B)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                zero_launches()
                det16.dispatches = 0
                t0 = time.perf_counter()
                got = bd.detect_batch(stack, n_real=[ns] * B)
                torch.cuda.synchronize()
                facade = (B, time.perf_counter() - t0, read_launches()["fused_picks"],
                          det16.dispatches, torch.cuda.max_memory_allocated(), got)
                break
            except torch.cuda.OutOfMemoryError as exc:
                notes.append(f"facade at B={B} ran out of memory ({type(exc).__name__})")
                del stack
                torch.cuda.empty_cache()
        if facade is None:
            fail("mxu: the batched facade ran out of memory at every batch size")
        B, t_slab, slab_launches, attempts, slab_peak, got = facade
        out["launches"] += slab_launches
        tiles16 = -(-nx // det16.effective_channel_tile) if det16._route() == "tiled" else 1
        if slab_launches != tiles16 * attempts:
            fail(f"mxu: the facade launched fused_picks {slab_launches} times in {attempts} "
                 "attempts")
        for b, entry in enumerate(got):
            if entry is None or _check_calls(scene, trim_picks(entry[0], ns)):
                fail(f"mxu: the batched facade's file {b} missed an injected call")
        del got, stack, cond
    say(f"mxu: full route (__call__) on matmul {t_full * 1e3:.1f} ms once, stage walls "
        f"{json.dumps({k: round(v, 3) for k, v in timer.walls().items()})} ms, "
        f"{full_launches} pick launches, picks bitwise detect_picks'; a second auto detector "
        f"on the same table: 0 measurements ({measured['n']} in the phase); batched facade "
        f"(batched mode) on matmul at [{B}, {nx}, {SLAB_BUCKET}]: {t_slab * 1e3:.1f} ms a "
        f"slab, {slab_launches} pick launches in {attempts} attempt(s), peak "
        f"{slab_peak / 2**30:.2f} GiB, every call picked in every file; TF32 off after the "
        f"phase; phase {time.perf_counter() - t_phase:.1f} s")
    return out


def phase_mxu_cpu_vs_card():
    """Every forced engine on the card against ``device="cpu"`` at 512 x
    12000: the contraction on one filtered block within 1e-4 * max|cpu|;
    end to end the float32 engines' correlograms and envelopes within
    1e-4 * max, thresholds rtol 1e-5 and picks up to 1e-5 knife edges
    where both resolved the same engine; the bf16 route end to end within
    ``MXU_CARD_BF16_REL`` * max (the filter's rounding moves a few inputs
    to the neighbouring bf16 value), thresholds at that rtol and picks at
    the knife margin that bound implies; the two gates' verdicts side by
    side (a difference is reported, not failed)."""
    import torch

    from das4whales_tpu_torch.io.synth import synthesize_scene, to_raw_counts
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.ops import spectral
    from das4whales_tpu_torch.utils.parity import unexplained_differences

    t_phase = time.perf_counter()
    nx, ns = 512, CANONICAL[1]
    scene = _scene(nx, ns, n_calls=1, seed=SEED + 1)
    raw = to_raw_counts(synthesize_scene(scene), scene.metadata)
    design = MatchedFilterDetector(scene.metadata, [0, nx, 1], (nx, ns), wire="raw",
                                   device="cpu").design
    rows = {}
    with _mxu_table():
        for label, engines in MXU_ENGINES[:4]:
            eng = engines["mf_engine"]
            dets, res, corr = {}, {}, {}
            for dev in ("cuda", "cpu"):
                det = MatchedFilterDetector.from_design(design, scene.metadata, wire="raw",
                                                        device=dev, **engines)
                dets[dev], res[dev] = det, det.detect_picks(raw)
                corr[dev] = _engine_corr(det, raw, eng).cpu().numpy()
            scale = float(np.abs(corr["cpu"]).max())
            # the contraction alone, on the CPU's filtered block on both devices
            trf = _engine_filter(dets["cpu"], raw, eng)[0]
            same_in = float(np.abs(_engine_corr(dets["cuda"], raw, eng, trf=trf).cpu().numpy()
                                   - _engine_corr(dets["cpu"], raw, eng, trf=trf).numpy()).max())
            if not same_in <= MXU_CARD_REL * scale:
                fail(f"mxu_cpu_vs_card: {label}: on one filtered block the correlograms differ "
                     f"by {same_in:.3e} (limit {MXU_CARD_REL * scale:.3e})")
            # end to end: the filter's cuFFT/pocketfft rounding moves a few
            # inputs to the neighbouring bf16 value, so the bf16 route has its
            # own fixed bound; the float32 engines are held at 1e-4 * max
            corr_lim = MXU_CARD_BF16_REL if eng == "matmul-bf16" else MXU_CARD_REL
            err = float(np.abs(corr["cuda"] - corr["cpu"]).max())
            if not err <= corr_lim * scale:
                fail(f"mxu_cpu_vs_card: {label}: correlograms differ by {err:.3e} "
                     f"(limit {corr_lim * scale:.3e})")
            # the picks ride the engine both devices resolved (a refusing gate
            # falls back to the float32 matmul)
            resolved = dets["cpu"].mf_engine
            same = dets["cuda"].mf_engine == resolved
            bf16 = resolved == "matmul-bf16"
            lim = MXU_CARD_BF16_REL if bf16 else MXU_CARD_REL
            thr_rtol = MXU_CARD_BF16_REL if bf16 else MXU_THR_RTOL
            n_diff, rels, env_rel = 0, {}, None
            if same:
                env = {d: spectral.envelope_sqrt(
                    torch.as_tensor(c) if resolved == eng
                    else _engine_corr(dets[d], raw).cpu()).numpy() for d, c in corr.items()}
                env_scale = float(env["cpu"].max())
                env_rel = float(np.abs(env["cuda"] - env["cpu"]).max()) / env_scale
                if not env_rel <= lim:
                    fail(f"mxu_cpu_vs_card: {label}: envelopes differ by {env_rel:.3e} of max "
                         f"(limit {lim:.3e})")
                for i, name in enumerate(res["cpu"].picks):
                    tg, tc = res["cuda"].thresholds[name], res["cpu"].thresholds[name]
                    rel = (_bf16_knife_rel(lim, env_scale, tc, thr_rtol) if bf16
                           else MXU_KNIFE_REL)
                    rels[name] = float(f"{rel:.3g}")
                    if not np.isclose(tg, tc, rtol=thr_rtol, atol=0):
                        fail(f"mxu_cpu_vs_card: {label}: {name} threshold card {tg} vs cpu {tc} "
                             f"(rtol {thr_rtol:.3g})")
                    a, b = res["cuda"].picks[name], res["cpu"].picks[name]
                    bad = unexplained_differences(a, b, env["cpu"][i], tc, rel)
                    if bad:
                        fail(f"mxu_cpu_vs_card: {label}: {name} picks differ beyond rounding "
                             f"(rel {rel:.3g}) at {bad[:10]}")
                    n_diff += len({tuple(p) for p in a.T.tolist()}
                                  ^ {tuple(p) for p in b.T.tolist()})
            if _check_calls(scene, res["cuda"].picks):
                fail(f"mxu_cpu_vs_card: {label}: the injected call was not picked on the card")
            rows[label] = {"card": f"{dets['cuda'].mf_engine}/{dets['cuda'].fk_engine}",
                           "cpu": f"{dets['cpu'].mf_engine}/{dets['cpu'].fk_engine}",
                           "corr_rel_one_input": float(f"{same_in / scale:.3g}"),
                           "corr_rel": float(f"{err / scale:.3g}"), "limit": corr_lim,
                           "env_rel": None if env_rel is None else float(f"{env_rel:.3g}"),
                           "knife_rel": rels,
                           "differing_picks": n_diff if same else "engines differ"}
            if label in ("matmul-bf16", "matmul-fused"):
                rows[label]["gate_card"] = dets["cuda"].mf_engine_reason
                rows[label]["gate_cpu"] = dets["cpu"].mf_engine_reason
    say(f"mxu_cpu_vs_card: {nx}x{ns} raw int32, card vs CPU, on one filtered block every "
        f"engine within {MXU_CARD_REL}*max; end to end correlograms and envelopes within "
        f"{MXU_CARD_REL}*max, thresholds rtol {MXU_THR_RTOL}, picks up to {MXU_KNIFE_REL} "
        f"knife edges (bf16: {MXU_CARD_BF16_REL}*max, rtol {MXU_CARD_BF16_REL}, the knife "
        f"margin that bound implies): "
        f"{json.dumps(rows)}; phase {time.perf_counter() - t_phase:.1f} s")


#: each phase's seconds in this run (``_time_phases``)
_PHASE_SECONDS: dict = {}


# ---------------------------------------------------------------------------
# Phases 32-33: the command line and the workflow mains (ROADMAP item 12)
# ---------------------------------------------------------------------------

#: the other mains run at this many channels (each f-k design a few seconds
#: of host work); the card against the CPU at WF_CPU_NX
WF_NX = 2048
WF_CPU_NX = 512
WF_SEED = SEED + 20
#: card against CPU: arrays an FFT op makes, of their max; the Radon
#: transform's; SNR and spectrogram dB (within 60 dB of the max); the
#: bathynoise SNR_1d and noise power dB
WF_REL = 1e-5
WF_RADON_REL = 1e-4
WF_SNR_DB = 0.01
WF_NOISE_DB = 1e-3
#: a Canny pixel is a knife edge where its direction bin, suppression or
#: threshold decision lies this close (relative; radians for the bin) to
#: its edge in a float64 recomputation
WF_CANNY_REL = 1e-5
WF_CLI_TIMEOUT = 600
#: intra-op threads of the processes that run beside the card's phases
#: (the flagship's spawned process, the command line's and the serve verb's
#: subprocesses): their work is on the card, and a thread a core each would
#: crowd the host the CPU side of those phases computes on
BESIDE_THREADS = 2
#: the figures the rendering verbs write (the JAX package's names)
MF_FIGURES = ("mf_detection.png", "mf_snr_HF.png", "mf_snr_LF.png", "mf_tx.png")

#: the workflow phases' files and their background jobs (``workflows_start``)
_WF: dict = {}


def _flagship_job(d: str):
    """``workflows.mfdetect.main`` at the canonical width in a spawned
    process on the card: a canonical Silixa TDMS file (22050 x 12000 raw
    int32, the canonical six calls, seed 2026) written with the port's
    writer, the main run on it as a user calls it (it designs in-process),
    its launches counted and the pick kernel held bitwise against its
    plain version at the route's first and last launch, every injected
    call checked, then the detection figure's device work
    (``viz.plot.envelope_np`` of ``trf_fk``). Returns its numbers."""
    from pathlib import Path

    import torch

    from das4whales_tpu_torch.ops import fused_picks
    from das4whales_tpu_torch.viz.plot import envelope_np
    from das4whales_tpu_torch.workflows import mfdetect

    nx, ns = CANONICAL
    paths, scenes, t_write = _write_files(Path(d), ((SEED, ns),), nx, n_calls=6)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()                           # the flagship main's run starts here
    with _capture(fused_picks, "picks_cuda") as calls:
        t0 = time.perf_counter()
        res = mfdetect.main(paths[0], interrogator="silixa")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    nT = len(res["picks"])
    tile = calls["first"][0][0].shape[0] // nT
    n_tiles = -(-nx // tile)
    if launches["fused_stft"] or launches["fused_picks"] % n_tiles or not launches["fused_picks"]:
        fail(f"workflows: mfdetect launched {launches}, expected {n_tiles} fused_picks an "
             "attempt and no fused_stft")
    err, notes = _picks_at_main_path("workflows: mfdetect", calls, {
        "first": nT * tile, "last": nT * (nx - (n_tiles - 1) * tile)})
    misses = _check_calls(scenes[0], res["picks"])
    if misses:
        fail(f"workflows: mfdetect missed injected calls at (channel, onset) {misses}")
    if not all(np.isfinite(t) and t > 0 for t in res["thresholds"].values()):
        fail(f"workflows: mfdetect thresholds {res['thresholds']}")
    t0 = time.perf_counter()
    env = envelope_np(res["trf_fk"])
    env_s = time.perf_counter() - t0
    if env.shape != (nx, ns) or not np.isfinite(env).all():
        fail(f"workflows: mfdetect's detection envelope {env.shape} not all finite")
    return {"t_write": t_write, "wall": wall, "timings": dict(res["timings"]),
            "launches": launches["fused_picks"], "attempts": launches["fused_picks"] // n_tiles,
            "n_tiles": n_tiles, "peak_gib": peak / 2**30, "err": err, "notes": notes,
            "n_picks": {k: int(v.shape[1]) for k, v in res["picks"].items()},
            "env_s": env_s, "thresholds": res["thresholds"]}


def _cli(d, name: str, argv: list, out: dict) -> None:
    """``python -m das4whales_tpu_torch <argv>`` from ``d``, its result kept
    in ``out[name]`` as ``(exit code, stdout, stderr, seconds)``."""
    from pathlib import Path

    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, MPLBACKEND="Agg", OMP_NUM_THREADS=str(BESIDE_THREADS),
               PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    # the preflight phase sets a memory budget in this process's
    # environment for one campaign; a verb run beside it takes none
    env.pop("DAS_HBM_BUDGET_GB", None)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "das4whales_tpu_torch", *argv], cwd=str(d),
                       env=env, capture_output=True, text=True, timeout=WF_CLI_TIMEOUT)
    out[name] = (p.returncode, p.stdout, p.stderr, time.perf_counter() - t0)


def _cli_jobs(d, f_wide: str, long_files: list, out: dict) -> None:
    """The command line on the card, one verb after another (run on a
    thread beside the card's phases): ``list``, ``evaluate --family mf``
    (the default sweep), ``longrecord --interrogator silixa`` over two
    files, ``mfdetect`` and ``campaign`` on the wide file, then ``fsck`` of
    the campaign's outdir. Where matplotlib is missing, ``mfdetect`` and
    ``campaign`` must exit 2 naming it."""
    try:
        _cli(d, "list", ["list"], out)
        _cli(d, "evaluate", ["evaluate", "--family", "mf", "--out", str(d / "eval.json")], out)
        _cli(d, "longrecord", ["longrecord", *long_files, "--interrogator", "silixa",
                               "--outdir", str(d / "lr")], out)
        _cli(d, "mfdetect", ["mfdetect", f_wide, "--interrogator", "silixa", "--outdir",
                             str(d / "mf")], out)
        _cli(d, "campaign", ["campaign", f_wide, "--interrogator", "silixa", "--outdir",
                             str(d / "camp")], out)
        _cli(d, "fsck", ["fsck", str(d / "camp")], out)
    except Exception as exc:  # noqa: BLE001 — reported and failed by phase_workflows
        out["error"] = repr(exc)


def workflows_start() -> dict:
    """Write the workflow phases' TDMS files under ``build/`` (a wide one of
    ``WF_NX`` channels, two ``WF_CPU_NX``-channel segments for the long
    record, one ``WF_CPU_NX``-channel file for the card-vs-CPU phase), then
    start the mains' card work in a spawned process (:func:`_workflows_job`)
    and the command line on a thread: both run beside the phases after
    this one.
    Idempotent; :func:`workflows_finish` removes the files."""
    import tempfile
    import threading
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context
    from pathlib import Path

    import torch

    if "job" in _WF:
        return _WF
    # the flagship's process needs about 12 GiB of the card: give back what
    # this process's allocator holds from the earlier phases
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    say(f"workflows: this process holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved, as the "
        "flagship's process starts")
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    d = Path(tempfile.mkdtemp(prefix="workflows_", dir=root))
    t0 = time.perf_counter()
    (f_wide,), _, _ = _write_files(d, ((WF_SEED, CANONICAL[1]),), WF_NX, n_calls=6)
    long_dir = d / "long"
    long_dir.mkdir()
    long_files, _, _ = _write_files(long_dir, ((WF_SEED + 2, CANONICAL[1]),
                                               (WF_SEED + 3, CANONICAL[1])), WF_CPU_NX,
                                    n_calls=2)
    _WF.update(dir=d, t_write=time.perf_counter() - t0)
    (d / "flagship").mkdir()
    pool = ProcessPoolExecutor(1, mp_context=get_context("spawn"))
    _WF["pool"] = pool
    _WF["job"] = pool.submit(_workflows_job, str(d / "flagship"), f_wide)
    cli_dir = d / "cli"
    cli_dir.mkdir()
    _WF["cli"] = {}
    _WF["cli_dir"] = cli_dir
    th = threading.Thread(target=_cli_jobs, args=(cli_dir, f_wide, long_files, _WF["cli"]),
                          daemon=True)
    th.start()
    _WF["cli_thread"] = th
    return _WF


def workflows_finish() -> None:
    """Wait for the workflow phases' background jobs and remove their files."""
    import shutil

    if not _WF:
        return
    th = _WF.get("cli_thread")
    if th is not None:
        th.join()
    pool = _WF.get("pool")
    if pool is not None:
        pool.shutdown(wait=True, cancel_futures=True)
    for key in ("dir", "cpu_dir"):
        if key in _WF:
            shutil.rmtree(_WF[key], ignore_errors=True)
    _WF.clear()


def workflows_reap() -> None:
    """Shut down the mains' spawned process once its job is done (the
    files stay for :func:`workflows_finish`)."""
    pool = _WF.pop("pool", None)
    if pool is not None:
        pool.shutdown(wait=True)


def _wf_cpu() -> tuple:
    """``(path, scene)`` of the card-vs-CPU mains' Silixa TDMS file
    (``WF_CPU_NX`` channels, six calls), written once a process under
    ``build/``; :func:`workflows_finish` removes it."""
    import tempfile
    from pathlib import Path

    if "cpu" not in _WF:
        root = Path(__file__).resolve().parent / "build"
        root.mkdir(exist_ok=True)
        d = Path(tempfile.mkdtemp(prefix="workflows_cpu_", dir=root))
        _WF["cpu_dir"] = d
        (f_cpu,), (s_cpu,), _ = _write_files(d, ((WF_SEED + 1, CANONICAL[1]),), WF_CPU_NX,
                                             n_calls=6)
        _WF["cpu"] = (f_cpu, s_cpu)
    return _WF["cpu"]


def _check_cli(out: dict, d) -> tuple:
    """Check the command line's runs (``_cli_jobs``); returns ``(notes,
    which matplotlib branch ran)``."""
    if "error" in out:
        fail(f"workflows: the command line's runs failed: {out['error']}")

    def ok(name, rc=0):
        got = out.get(name)
        if got is None:
            fail(f"workflows: `{name}` did not run")
        if got[0] != rc:
            fail(f"workflows: `{name}` exited {got[0]}, expected {rc}: {got[2][-1500:]}")
        return got

    notes = []
    rc, o, _, t = ok("list")
    if "mfdetect" not in o or "bathynoise" not in o:
        fail(f"workflows: `list` printed {o!r}")
    notes.append(f"list {t:.1f} s")
    rc, o, _, t = ok("evaluate")
    rows = json.loads((d / "eval.json").read_text())
    if len(rows) != 5 or rows[-1]["HF"]["recall"] <= 0 or json.loads(o) != rows:
        fail(f"workflows: `evaluate` rows {rows}")
    notes.append(f"evaluate --family mf {t:.1f} s (recall at amplitude 1.0: HF "
                 f"{rows[-1]['HF']['recall']:.2f}, LF {rows[-1]['LF']['recall']:.2f})")
    rc, o, _, t = ok("longrecord")
    summ = json.loads((d / "lr" / "summary.json").read_text())
    if summ["n_files"] != 2 or "2 files as one" not in o or not (d / "lr" / "picks.npz").exists():
        fail(f"workflows: `longrecord` wrote {summ}")
    notes.append(f"longrecord --interrogator silixa {t:.1f} s ({summ['n_picks']} picks)")
    if _PKGS.get("matplotlib"):
        rc, o, _, t = ok("mfdetect")
        figs = sorted(os.listdir(d / "mf"))
        if tuple(figs) != MF_FIGURES or not all((d / "mf" / f).stat().st_size > 0 for f in figs):
            fail(f"workflows: `mfdetect` wrote {figs}, expected {MF_FIGURES}")
        if not any(ln.startswith("mfdetect: template HF:") for ln in o.splitlines()):
            fail("workflows: `mfdetect` printed no pick line")
        notes.append(f"mfdetect --outdir {t:.1f} s ({', '.join(figs)})")
        rc, o, _, t = ok("campaign")
        for f in ("density.png", "summary.json"):
            if not (d / "camp" / f).stat().st_size > 0:
                fail(f"workflows: `campaign` wrote no {f}")
        if "campaign: 1 done, 0 failed" not in o:
            fail(f"workflows: `campaign` printed {o!r}")
        notes.append(f"campaign {t:.1f} s (density.png, summary.json)")
        branch = "matplotlib imports: mfdetect and campaign rendered their figures"
    else:
        for name in ("mfdetect", "campaign"):
            rc, _, e, t = ok(name, rc=2)
            if "needs matplotlib" not in e:
                fail(f"workflows: `{name}` exited 2 without naming matplotlib: {e[-500:]}")
        for sub in ("mf", "camp"):
            if (d / sub).exists():
                fail(f"workflows: `{sub}` wrote its outdir without matplotlib")
        branch = ("matplotlib missing: mfdetect and campaign exited 2 naming it, before "
                  "reading the file")
    rc, o, _, t = ok("fsck")
    notes.append(f"fsck {t:.1f} s ({o.strip()})")
    return notes, branch


def _wide_mains(f_wide: str, scene) -> dict:
    """``spectrodetect``, ``gabordetect``, ``fkcomp``, ``plots`` and
    ``bathynoise`` mains on the ``WF_NX``-channel file, each as a user
    calls it (its own f-k design): walls, launches counted from 0 before
    each main, both kernels held against their plain versions at their
    first and last launch, every call picked where the family picks,
    bathynoise's stats against float64 on the host. Returns the notes,
    launches and errors."""
    import torch

    from das4whales_tpu_torch.ops import fused_picks, fused_stft, spectral
    from das4whales_tpu_torch.workflows import (bathynoise, fkcomp, gabordetect, plots,
                                                spectrodetect)

    nx, ns = WF_NX, scene.ns
    fs = scene.fs
    walls, notes = {}, []

    def run(name, main, capture=None):
        zero_launches()                       # this main's run starts here
        torch.cuda.reset_peak_memory_stats()
        with contextlib.ExitStack() as st:
            calls = st.enter_context(_capture(*capture)) if capture else None
            t0 = time.perf_counter()
            res = main(f_wide, interrogator="silixa")
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
        return res, read_launches(), calls, torch.cuda.max_memory_allocated()

    res, la, calls, peak = run("spectrodetect", spectrodetect.main,
                               (fused_stft, "stft_power_cuda"))
    n_k = len(res["picks"])
    if la != {"fused_picks": 0, "fused_stft": n_k * -(-nx // 4096)}:
        fail(f"workflows: spectrodetect launched {la}")
    stft_launches = la["fused_stft"]
    stft_err, stft_rel, _ = _stft_at_main_path("workflows: spectrodetect", calls, (nx, ns))
    picks = {k: np.asarray([v[0], np.round(v[1] * fs / res["spectro_fs"]).astype(int)])
             for k, v in res["picks"].items()}
    if _check_calls(scene, picks):
        fail(f"workflows: spectrodetect missed calls {_check_calls(scene, picks)}")
    notes.append(f"spectrodetect {walls['spectrodetect']:.2f} s, {stft_launches} fused_stft "
                 f"(within {stft_rel:.2e}*max of plain at the first and last), peak "
                 f"{peak / 2**30:.2f} GiB")
    del res, calls

    res, la, calls, peak = run("gabordetect", gabordetect.main, (fused_picks, "picks_cuda"))
    n_notes = len(res["picks"])
    if la["fused_stft"] or la["fused_picks"] < n_notes:
        fail(f"workflows: gabordetect launched {la}, expected one fused_picks a note")
    gabor_launches = la["fused_picks"]
    gabor_err, _ = _picks_at_main_path("workflows: gabordetect", calls,
                                       {"first": nx, "last": nx})
    if _check_calls(scene, res["picks"]):
        fail(f"workflows: gabordetect missed calls {_check_calls(scene, res['picks'])}")
    notes.append(f"gabordetect {walls['gabordetect']:.2f} s (stages "
                 f"{ {k: round(v, 2) for k, v in res['timings'].items()} }), {gabor_launches} "
                 f"fused_picks bitwise plain at the first and last, peak "
                 f"{peak / 2**30:.2f} GiB")
    del res, calls

    res, la, _, peak = run("fkcomp", fkcomp.main)
    if any(la.values()):
        fail(f"workflows: fkcomp launched {la}; its path has no kernel")
    for name, trf in res["filtered"].items():
        if tuple(trf.shape) != (nx, ns) or not bool(torch.isfinite(trf).all()):
            fail(f"workflows: fkcomp {name} filtered block not finite")
        if not res["compression"][name]["ratio"] > 1 or bool(torch.isnan(res["snr"][name]).any()):
            fail(f"workflows: fkcomp {name}: compression {res['compression'][name]}")
    notes.append(f"fkcomp {walls['fkcomp']:.2f} s (4 designs and applies), compression "
                 f"{ {k: round(v['ratio'], 1) for k, v in res['compression'].items()} }")
    del res

    res, la, _, peak = run("plots", plots.main)
    p, tt, ff = res["spectrogram"]
    if any(la.values()) or not bool(torch.isfinite(p).any()) or p.shape[-1] != len(tt):
        fail(f"workflows: plots launched {la} or gave a spectrogram of shape {tuple(p.shape)}")
    notes.append(f"plots {walls['plots']:.2f} s (best channel {res['best_channel']})")
    del res

    res, la, _, peak = run("bathynoise", bathynoise.main)
    if any(la.values()):
        fail(f"workflows: bathynoise launched {la}; its path has no kernel")
    st = res["stats"]
    trf = res["trf_fk"]
    env_card = spectral.envelope(trf).cpu().numpy()
    trf64 = trf.cpu().numpy().astype(np.float64)
    from scipy.signal import hilbert

    env64 = np.abs(hilbert(trf64, axis=-1))
    med64 = np.median(env64, axis=-1)
    mean64 = env64.mean(axis=-1)
    std64 = trf64.std(axis=-1)
    snr64 = 20 * np.log10(std64 / med64)
    i1 = int(5.0 * fs)
    pow64 = 10 * np.log10(np.mean(trf64[:, :i1] ** 2, axis=-1) / 1e-22)
    rel = {k: float(np.max(np.abs(st[k] - v) / np.abs(v)))
           for k, v in (("med", med64), ("mean", mean64), ("std", std64))}
    # the median is one envelope sample: held by its row's envelope difference
    med_bound = np.abs(env_card - env64).max(axis=-1)
    if not (rel["mean"] <= WF_REL and rel["std"] <= WF_REL
            and np.all(np.abs(st["med"] - med64) <= np.maximum(WF_REL * med64, med_bound))):
        fail(f"workflows: bathynoise stats against float64: {rel} (median bound: the row's "
             f"envelope difference, max {float(med_bound.max()):.3e})")
    d_snr = float(np.abs(st["snr_1d"] - snr64).max())
    d_pow = float(np.abs(st["noise_power_db"] - pow64).max())
    if not (d_snr <= WF_NOISE_DB and d_pow <= WF_NOISE_DB):
        fail(f"workflows: bathynoise snr_1d {d_snr:.2e} dB, noise power {d_pow:.2e} dB from "
             "float64")
    notes.append(f"bathynoise {walls['bathynoise']:.2f} s (against float64 on the host: med "
                 f"{rel['med']:.2e}, mean {rel['mean']:.2e}, std {rel['std']:.2e} relative, "
                 f"snr_1d {d_snr:.2e} dB, noise power {d_pow:.2e} dB)")
    return {"notes": notes, "gabor_launches": gabor_launches, "gabor_err": gabor_err,
            "stft_launches": stft_launches, "stft_err": stft_err}


def _workflows_job(d: str, f_wide: str) -> dict:
    """The workflow phase's card work in a spawned process: the flagship
    main (:func:`_flagship_job`), then the other five at ``WF_NX``
    channels (:func:`_wide_mains`), on ``BESIDE_THREADS`` intra-op
    threads."""
    import torch

    torch.set_num_threads(BESIDE_THREADS)
    flagship = _flagship_job(d)
    wide = _wide_mains(f_wide, _scene(WF_NX, CANONICAL[1], n_calls=6, seed=WF_SEED))
    return {"flagship": flagship, "wide": wide}


def phase_workflows():
    """The workflow mains on the card as a user calls them (run by
    :func:`workflows_start`'s spawned process beside the card's
    phases): the flagship at full width, the other five at ``WF_NX`` x
    12000; and the command line as subprocesses."""
    wf = workflows_start()
    t0 = time.perf_counter()
    out = wf["job"].result()
    t_wait = time.perf_counter() - t0
    fl, wide = out["flagship"], out["wide"]
    say(f"workflows: the mains at {WF_NX}x{CANONICAL[1]} (a Silixa TDMS file, raw int32, 6 "
        f"calls; interrogator='silixa'), walls with each f-k design (beside the card's "
        f"phases): {'; '.join(wide['notes'])}; spectro and gabor picked every injected call")
    say(f"workflows: the flagship mfdetect.main at {CANONICAL[0]}x{CANONICAL[1]} in a spawned "
        f"process beside the card's phases (file written in {fl['t_write']:.1f} s): "
        f"wall {fl['wall']:.1f} s, stage walls "
        f"{json.dumps({k: round(v, 3) for k, v in fl['timings'].items()})} s, "
        f"{fl['launches']} fused_picks launches ({fl['attempts']} attempt(s) of "
        f"{fl['n_tiles']}), peak {fl['peak_gib']:.2f} GiB, picks {json.dumps(fl['n_picks'])}, "
        f"every injected call picked; the detection envelope (viz.plot.envelope_np) "
        f"{fl['env_s']:.3f} s; fused_picks bitwise plain: {'; '.join(fl['notes'])} "
        f"(waited {t_wait:.1f} s for the spawned process here)")

    wf["cli_thread"].join()
    cli_notes, branch = _check_cli(wf["cli"], wf["cli_dir"])
    say(f"workflows: python -m das4whales_tpu_torch on the card: {'; '.join(cli_notes)}; "
        f"{branch}")
    return {"launches": {"workflows_mfdetect": fl["launches"],
                         "workflows_gabor": wide["gabor_launches"]},
            "stft_launches": {"workflows_spectro": wide["stft_launches"]},
            "err": max(fl["err"], wide["gabor_err"]), "stft_err": wide["stft_err"]}


def _canny_knife_seeds(img: np.ndarray, low: float, high: float) -> np.ndarray:
    """Pixels of a float64 recomputation of the Canny stages whose direction
    bin, suppression or threshold decision lies within ``WF_CANNY_REL`` of
    its edge."""
    from scipy import ndimage

    x = np.pad(img.astype(np.float64), 1, mode="edge")
    sx = np.array([[-1.0, 0, 1], [-2, 0, 2], [-1, 0, 1]])
    gx = ndimage.correlate(x, sx, mode="constant")[1:-1, 1:-1]
    gy = ndimage.correlate(x, sx.T, mode="constant")[1:-1, 1:-1]
    mag = np.abs(gx) + np.abs(gy)
    tol = WF_CANNY_REL * max(float(mag.max()), high)
    ang = np.arctan2(gy, gx)
    ang = np.where(ang < 0, ang + np.pi, ang)
    q = (ang + np.pi / 8) / (np.pi / 4)
    seeds = np.abs(q - np.round(q)) * (np.pi / 4) <= WF_CANNY_REL
    mp = np.pad(mag, 1)
    h, w = img.shape
    for dy, dx in ((0, 1), (1, 1), (1, 0), (1, -1)):
        for sgn in (1, -1):
            nb = mp[1 + sgn * dy: 1 + sgn * dy + h, 1 + sgn * dx: 1 + sgn * dx + w]
            seeds |= np.abs(mag - nb) <= tol
    return seeds | (np.abs(mag - low) <= tol) | (np.abs(mag - high) <= tol)


def _canny_flips(where: str, img: np.ndarray, low: float, high: float, ref, got) -> int:
    """Canny maps equal up to counted knife edges: every flipped pixel
    8-connected, through either map's edges, to a knife-edge pixel."""
    from scipy import ndimage

    diff = ref != got
    if not diff.any():
        return 0
    seeds = _canny_knife_seeds(img, low, high)
    comp, _ = ndimage.label(ref | got | seeds, structure=np.ones((3, 3)))
    explained = np.isin(comp, np.unique(comp[seeds & (comp > 0)]))
    bad = int((diff & ~explained).sum())
    if bad:
        fail(f"{where}: {bad} of {int(diff.sum())} flipped Canny pixels are not on a knife edge")
    return int(diff.sum())


def _near(where: str, label: str, card, cpu, rel: float) -> float:
    """``card`` within ``rel * max|cpu|``; returns the relative error."""
    a = card.cpu().numpy() if hasattr(card, "cpu") else np.asarray(card)
    b = cpu.cpu().numpy() if hasattr(cpu, "cpu") else np.asarray(cpu)
    if a.shape != b.shape:
        fail(f"{where}: {label} shape {a.shape} vs {b.shape}")
    scale = float(np.abs(b).max())
    e = float(np.abs(a.astype(np.float64) - b).max()) / scale if scale else 0.0
    if not e <= rel:
        fail(f"{where}: {label} card vs CPU {e:.3e} * max (limit {rel})")
    return e


def _db_near(where: str, label: str, card, cpu, tol: float = WF_SNR_DB) -> float:
    a, b = (x.cpu().numpy().astype(np.float64) for x in (card, cpu))
    keep = np.isfinite(b) & (b >= np.nanmax(b) - 60.0)
    d = float(np.abs(a[keep] - b[keep]).max())
    if not d <= tol:
        fail(f"{where}: {label} card vs CPU {d:.3e} dB within 60 dB of the max (limit {tol})")
    return d


def phase_workflows_cpu_vs_card():
    """Each main at ``WF_CPU_NX`` x 12000 on the card and with
    ``device="cpu"``, and the ten image ops on the Gabor family's binned
    image."""
    import torch

    from das4whales_tpu_torch.models.gabor import GaborDetector, _gabor_score
    from das4whales_tpu_torch.ops import image as timg
    from das4whales_tpu_torch.ops import spectral
    from das4whales_tpu_torch.utils.parity import unexplained_differences
    from das4whales_tpu_torch.viz.plot import envelope_np, fx_panels
    from das4whales_tpu_torch.workflows import (bathynoise, fkcomp, gabordetect, mfdetect,
                                                plots, spectrodetect)

    W = "workflows_cpu_vs_card"
    path, scene = _wf_cpu()
    nx, ns, fs = WF_CPU_NX, scene.ns, scene.fs
    worst, notes = {}, []

    def both(main, **kw):
        return {dev: main(path, interrogator="silixa", device=dev, **kw)
                for dev in ("cuda", "cpu")}

    def panel(trf_g, trf_c):
        return _near(W, "detection envelope", envelope_np(trf_g, "cuda"),
                     envelope_np(trf_c, "cpu"), WF_REL)

    # mfdetect: the full artifact route
    r = both(mfdetect.main)
    g, c = r["cuda"], r["cpu"]
    for name in c["thresholds"]:
        if not np.isclose(g["thresholds"][name], c["thresholds"][name], rtol=1e-5, atol=0):
            fail(f"{W}: mfdetect {name} threshold {g['thresholds'][name]} vs "
                 f"{c['thresholds'][name]}")
    worst["mf trf_fk"] = _near(W, "mfdetect trf_fk", g["trf_fk"], c["trf_fk"], WF_REL)
    worst["mf panel"] = panel(g["trf_fk"], c["trf_fk"])
    names = list(c["picks"])
    n_mf = _same_picks(f"{W}: mfdetect", g["picks"], c["picks"], lambda: np.stack(
        [spectral.envelope_sqrt(c["correlograms"][n]).numpy() for n in names]),
        c["thresholds"])
    if _check_calls(scene, g["picks"]):
        fail(f"{W}: mfdetect missed calls on the card")
    notes.append(f"mfdetect {n_mf} picks differing")
    del r, g, c

    r = both(spectrodetect.main)
    g, c = r["cuda"], r["cpu"]
    worst["spectro trf_fk"] = _near(W, "spectrodetect trf_fk", g["trf_fk"], c["trf_fk"], WF_REL)
    worst["spectro panel"] = panel(g["trf_fk"], c["trf_fk"])
    n_sp = 0
    for name, cc in c["correlograms"].items():
        worst[f"spectro corr {name}"] = _near(W, f"spectrodetect {name} correlograms",
                                              g["correlograms"][name], cc, 1e-4)
        bad = unexplained_differences(g["picks"][name], c["picks"][name], cc.numpy(), 14.0)
        if bad:
            fail(f"{W}: spectrodetect {name} picks differ beyond rounding at {bad[:10]}")
        n_sp += len({tuple(p) for p in np.asarray(g["picks"][name]).T.tolist()}
                    ^ {tuple(p) for p in np.asarray(c["picks"][name]).T.tolist()})
    if g["spectro_fs"] != c["spectro_fs"]:
        fail(f"{W}: spectro_fs {g['spectro_fs']} vs {c['spectro_fs']}")
    notes.append(f"spectrodetect {n_sp} picks differing")
    del r, g, c

    r = both(gabordetect.main)
    g, c = r["cuda"], r["cpu"]
    worst["gabor trf_fk"] = _near(W, "gabordetect trf_fk", g["trf_fk"], c["trf_fk"], WF_REL)
    worst["gabor panel"] = panel(g["trf_fk"], c["trf_fk"])
    worst["gabor score"] = _near(W, "gabordetect score", g["score"], c["score"], GABOR_CARD_REL)
    det_c = GaborDetector(scene.metadata.with_shape(nx, ns), [0, nx, 1], device="cpu")
    d = det_c.design
    n_bin = _gabor_knife_edges("binary", c["score"], d.threshold1,
                               g["score"].cpu() > d.threshold1, GABOR_CARD_REL, where=W)
    up, down = det_c._kernels
    s2 = _gabor_score((g["score"].cpu() > d.threshold1).float(), up, down)
    n_mask = _gabor_knife_edges("mask", s2, d.threshold2, g["mask"].cpu(), GABOR_CARD_REL,
                                where=W)
    if n_bin or n_mask:
        notes.append(f"gabordetect: {n_bin} binary and {n_mask} mask pixels on knife edges; "
                     "picks not compared")
    else:
        n_gb = 0
        for name, cc in c["correlograms"].items():
            worst[f"gabor corr {name}"] = _near(W, f"gabordetect {name} correlograms",
                                                g["correlograms"][name], cc, GABOR_CARD_REL)
            if not np.isclose(g["thresholds"][name], c["thresholds"][name], rtol=1e-5, atol=0):
                fail(f"{W}: gabordetect {name} threshold {g['thresholds'][name]} vs "
                     f"{c['thresholds'][name]}")
            bad = unexplained_differences(g["picks"][name], c["picks"][name],
                                          spectral.envelope_sqrt(cc).numpy(),
                                          c["thresholds"][name])
            if bad:
                fail(f"{W}: gabordetect {name} picks differ beyond rounding at {bad[:10]}")
            n_gb += len({tuple(p) for p in np.asarray(g["picks"][name]).T.tolist()}
                        ^ {tuple(p) for p in np.asarray(c["picks"][name]).T.tolist()})
        notes.append(f"gabordetect binary image and mask equal, {n_gb} picks differing")
    trf_cpu = c["trf_fk"]
    del r, g, c

    r = both(fkcomp.main)
    for name, fc in r["cpu"]["filtered"].items():
        worst[f"fkcomp {name}"] = _near(W, f"fkcomp {name}", r["cuda"]["filtered"][name], fc,
                                        WF_REL)
        worst[f"fkcomp snr {name} dB"] = _db_near(W, f"fkcomp {name} SNR",
                                                  r["cuda"]["snr"][name], r["cpu"]["snr"][name])
    del r

    r = both(plots.main)
    g, c = r["cuda"], r["cpu"]
    worst["plots trf_fk"] = _near(W, "plots trf_fk", g["trf_fk"], c["trf_fk"], WF_REL)
    if g["best_channel"] != c["best_channel"]:
        fail(f"{W}: plots best channel {g['best_channel']} vs {c['best_channel']}")
    (gp, gtt, gff), (cp, ctt, cff) = g["spectrogram"], c["spectrogram"]
    if not (np.array_equal(gtt, ctt) and np.array_equal(gff, cff)):
        fail(f"{W}: plots spectrogram axes differ")
    # the spectrogram is dB re its max: held on its linear magnitude (max 1)
    worst["plots spectrogram"] = _near(W, "plots spectrogram", 10 ** (gp.cpu() / 20),
                                       10 ** (cp / 20), WF_REL)
    # the f-x panels on one input (the CPU's filtered rows on both): a quiet
    # window's panel is small against the block's max, where trf_fk's
    # card-vs-CPU rounding sits
    step = max(nx // 64, 1)
    rows = c["trf_fk"][::step]
    for k, (a, b) in enumerate(zip(fx_panels(rows.to("cuda"), fs, nfft=512, device="cuda"),
                                   fx_panels(rows, fs, nfft=512, device="cpu"))):
        worst[f"plots f-x {k}"] = _near(W, f"plots f-x panel {k}", a, b, WF_REL)
    del r, g, c

    r = both(bathynoise.main)
    gs, cs = r["cuda"]["stats"], r["cpu"]["stats"]
    for key in ("mean", "std"):
        e = float(np.max(np.abs(gs[key] - cs[key]) / np.abs(cs[key])))
        worst[f"bathynoise {key}"] = e
        if not e <= WF_REL:
            fail(f"{W}: bathynoise {key} card vs CPU {e:.3e} relative (limit {WF_REL})")
    # the median is one envelope sample (or the mean of two): it moves no more
    # than the samples do, and each sample's rounding scales with its row's
    # max, where a mean averages it away
    env_diff = (spectral.envelope(r["cuda"]["trf_fk"]).cpu()
                - spectral.envelope(r["cpu"]["trf_fk"])).abs().amax(dim=-1).numpy()
    d_med = np.abs(gs["med"] - cs["med"])
    worst["bathynoise med"] = float(np.max(d_med / np.abs(cs["med"])))
    if not np.all(d_med <= np.maximum(WF_REL * np.abs(cs["med"]), env_diff)):
        fail(f"{W}: bathynoise med card vs CPU beyond its row's envelope difference")
    for key in ("snr_1d", "noise_power_db"):
        e = float(np.max(np.abs(gs[key] - cs[key])))
        worst[f"bathynoise {key} dB"] = e
        if not e <= WF_NOISE_DB:
            fail(f"{W}: bathynoise {key} card vs CPU {e:.3e} dB (limit {WF_NOISE_DB})")
    del r

    # the ten image ops on the Gabor family's binned image (the CPU's, on both)
    img_c = timg.binning(timg.trace2image(trf_cpu), 0.1, 0.1)
    img_g = img_c.to("cuda")
    ops = (("gaussian_blur_cv", lambda x: timg.gaussian_blur_cv(x, 5, 0.0), WF_REL),
           ("gradient_oriented", lambda x: timg.gradient_oriented(x, (2, 1)), WF_REL),
           ("detect_diagonal_edges", timg.detect_diagonal_edges, WF_REL),
           ("diagonal_edge_detection", timg.diagonal_edge_detection, WF_REL),
           ("bilateral_filter", lambda x: timg.bilateral_filter(x, 9, 75.0, 75.0), WF_REL),
           ("radon_transform", timg.radon_transform, WF_RADON_REL),
           ("compute_radon_transform", timg.compute_radon_transform, WF_RADON_REL))
    for name, fn, rel in ops:
        worst[name] = _near(W, name, fn(img_g), fn(img_c), rel)
    smooth = timg.bilateral_filter(img_c, 9, 75.0, 75.0)
    e_c = timg.canny_edges(smooth, 50.0, 150.0)
    e_g = timg.canny_edges(smooth.to("cuda"), 50.0, 150.0).cpu()
    n_canny = _canny_flips(f"{W}: canny_edges", smooth.numpy(), 50.0, 150.0, e_c.numpy(),
                           e_g.numpy())
    kw = dict(threshold=30, min_line_length=20, max_line_gap=5)
    lines = timg.hough_lines(e_c, **kw)
    if timg.hough_lines(e_c.to("cuda"), **kw) != lines:
        fail(f"{W}: hough_lines on the same edge map differ card vs CPU")
    ll_c, le_c = timg.detect_long_lines(img_c, **kw)
    ll_g, le_g = timg.detect_long_lines(img_g, **kw)
    n_long = _canny_flips(f"{W}: detect_long_lines", smooth.numpy(), 50.0, 150.0,
                          le_c.numpy(), le_g.cpu().numpy())
    if n_long == 0 and ll_g != ll_c:
        fail(f"{W}: detect_long_lines on equal edge maps found different lines")
    torch.cuda.synchronize()
    notes.append(f"image ops on the {tuple(img_c.shape)} binned image: Canny {n_canny} "
                 f"pixels on knife edges of {int(e_c.sum())} edges, Hough {len(lines)} "
                 f"segments equal on the same edge map, detect_long_lines {len(ll_c)} "
                 f"segments ({n_long} edge pixels on knife edges)")
    say(f"{W}: the six mains at {nx}x{ns} (Silixa TDMS) on the card against "
        f"device='cpu': thresholds rtol 1e-5, FFT-made arrays within {WF_REL}*max (the "
        f"spectrogram on its linear magnitude; spectro correlograms 1e-4, Gabor score "
        f"{GABOR_CARD_REL}, Radon {WF_RADON_REL}), SNR within {WF_SNR_DB} dB where within 60 "
        f"dB of the max, bathynoise mean and std {WF_REL} relative, med {WF_REL} relative or "
        f"within its row's envelope difference, dB within {WF_NOISE_DB}; "
        f"{'; '.join(notes)}; measured "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in worst.items()})}")



# ---------------------------------------------------------------------------
# Phases 35-36: the matched filter over a device mesh (ROADMAP item 14)
# ---------------------------------------------------------------------------

#: the mesh phase's ranks: two processes sharing the one card over gloo
#: (NCCL refuses two ranks on one device: "Duplicate GPU detected")
MESH_RANKS = 2
#: every collective of a rank's process group is bounded by this: a rank
#: that dies fails its peer within it
MESH_GROUP_TIMEOUT_S = 90.0
#: the launcher's wait for a pool of ranks, the kill after it
MESH_POOL_TIMEOUT_S = 600.0
#: the phase's budget less its family items (6-11) and their checks, which
#: have their own (the ranks run items 6-10 after items 1-4; 11 is a pool apart)
MESH_BUDGET_S = 120.0
MESH_FAMILY_BUDGET_S = 100.0
MESH_CPU_BUDGET_S = 40.0
#: the mesh phase's relative bound on trf_fk against filter_block's (one
#: card, two FFT groupings), and the card-vs-CPU phase's
MESH_REL = 1e-5
MESH_CPU_REL = 1e-4
MESH_THR_RTOL = 1e-5
#: the command-line item's channel selection (the command designs in-process)
MESH_CLI_CHANNELS = 2048
#: item 4's files: the first two slab files, one a rank at (file=2) (two,
#: not four, for the run's time limit: each rank still reads, writes and
#: resumes its own)
MESH_CAMPAIGN_FILES = 2
#: the long record's halo (staged) bandpass runs on this many channels
#: around the straddling call (a cut for the phase's budget: the full-width
#: record takes the fused route)
MESH_HALO_CHANNELS = 2048
#: the spectro long record over the mesh runs on this many channels around
#: the straddling call (a cut for the phase's budget: its time-split step
#: frames every band row of a channel before the relabel, through gloo)
MESH_SPECTRO_CHANNELS = 4096
#: the Gabor long record over the mesh runs on the record's first rows: at
#: P = 2 the canonical 22050 rows fail the binning grain (11025 x 0.1)
MESH_GABOR_CHANNELS = 22000
#: the channel-sharded spectro step's tile (its default): one STFT launch a
#: tile of a rank's channels
MESH_SPECTRO_TILE = 256
#: rows of the pick kernel's plain version a pass when a rank holds a
#: launch against it
PICK_CHECK_ROWS = 8192
#: the elastic drill's probe deadline (the campaign's own is 30 s,
#: ``workflows.campaign._DEVICE_PROBE_DEADLINE_S``) and its pool's
#: collective timeout: the survivor's check-in waits their sum, since the
#: drill's victim never checks in (and a peer of a rank that failed alone
#: would reach the check-in only after its collective's timeout)
MESH_ELASTIC_DEADLINE_S = 5.0
MESH_ELASTIC_GROUP_TIMEOUT_S = 20.0
#: a rank waits this long for the phase's inputs (the ranks start while
#: the smoke writes them)
MESH_READY_TIMEOUT_S = 300.0
#: the long record's items share the longrecord phase's files and design
#: when it ran first (main keeps them until this phase has run)
_LONG_REF: dict = {}
#: a rank's one-card detector of the canonical design (item 1 builds it)
_RANK_DET: dict = {}


def _rank_kernel_check(calls: dict, where: str = "mesh: rank kernel check") -> tuple:
    """This rank's first and last pick launch held against the plain
    version on their own inputs, at the launch's own K and method: all
    five outputs bitwise. Returns ``(max_abs_err, [rows first, rows
    last])``; the comparison's own launches are made after the count was
    read."""
    import torch

    from das4whales_tpu_torch.ops import fused_picks

    err, rows = 0.0, []
    for which in ("first", "last"):
        (X, thr, K, method, *rest), kw = calls[which]
        # in row blocks (each row is its own CTA, so a block's rows are the
        # launch's bit for bit): a long record's launch of 22000 x 24000
        # would take its plain version's tables at once
        for lo in range(0, X.shape[0], PICK_CHECK_ROWS):
            blk = slice(lo, lo + PICK_CHECK_ROWS)
            k_out = fused_picks.picks_cuda(X[blk], thr[blk], K, method, *rest, **kw)
            p_out = fused_picks.picks_plain(X[blk], thr[blk], K, method)
            torch.cuda.synchronize()
            err = max(err, _compare(k_out, p_out, f"{where} ({which} launch)"))
            del k_out, p_out
        rows.append(int(X.shape[0]))
    return err, rows


def _rank_picks(sp, n_samples: int, names, row_offset: int) -> list:
    """A rank's ``[nT, B, C, K]`` sparse picks as per-file ``{name: (2, n)}``
    with the rank's channel offset (row-major)."""
    from das4whales_tpu_torch.ops import peaks as peak_ops

    pos = sp.positions.cpu().numpy()
    sel = sp.selected.cpu().numpy() & (pos < n_samples)
    out = []
    for b in range(pos.shape[1]):
        out.append({name: peak_ops.sparse_to_pick_times(pos[i, b], sel[i, b])
                    + np.array([[row_offset], [0]]) for i, name in enumerate(names)})
    return out


def _rank_item_step(spec, rank):
    """Item 1: two ranks on the card over gloo, mesh (file=1, channel=2),
    the raw canonical block through the adaptive pair; then
    ``outputs="full"``'s gathered ``trf_fk`` against ``filter_block``'s."""
    import torch

    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.ops import fused_picks
    from das4whales_tpu_torch.parallel import collectives as coll
    from das4whales_tpu_torch.parallel.mesh import Sharding, make_mesh
    from das4whales_tpu_torch.parallel.pipeline import input_sharding, make_sharded_mf_step
    from das4whales_tpu_torch.utils.checkpoint import load_design
    from das4whales_tpu_torch.workflows import campaign as cmod

    dev = spec["device"]
    design = load_design(spec["design"])
    mesh = make_mesh((1, MESH_RANKS), ("file", "channel"), devices=[dev] * MESH_RANKS,
                     backend="gloo")
    raw = np.load(spec["raw"], mmap_mode="r")
    x = input_sharding(mesh).place(raw[None])
    wire = dict(wire="raw", scale_factor=spec["scale_factor"])
    k0, full = cmod._adaptive_sharded_steps(make_sharded_mf_step, design, mesh, **wire)
    k0(x)                                   # warm-up: cuFFT plans, the kernel's load
    on_card = x.is_cuda
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    coll.reset_stats()
    fused_picks.launches = 0                # the main path's run starts here
    with _capture(fused_picks, "picks_cuda") as calls:
        t0 = time.perf_counter()
        sp, thres, esc = cmod._run_adaptive(k0, full, x, mesh)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = fused_picks.launches
    stats = coll.read_stats()
    c_local = design.trace_shape[0] // MESH_RANKS
    picks = _rank_picks(sp, design.trace_shape[1], design.template_names,
                        mesh.axis_index("channel") * c_local)
    err, rows = (_rank_kernel_check(calls) if on_card else (0.0, []))
    parts = coll.all_gather_object(picks[0], mesh)
    merged = {name: np.concatenate([p[name] for p in parts], axis=1)
              for name in design.template_names}
    out = dict(picks=merged, thres=thres.cpu().numpy(), escalated=esc, launches=launches,
               attempts=1 + int(esc), kernel_err=err, kernel_rows=rows, wall=wall,
               stats=stats, peak=torch.cuda.max_memory_allocated() if on_card else 0)
    # the full outputs: trf_fk, correlograms and envelopes gathered
    del sp
    step_full = make_sharded_mf_step(design, mesh, outputs="full", **wire)
    coll.reset_stats()
    trf, corr, env, _, thres_f = step_full(x)
    out["full_stats"] = coll.read_stats()
    g_trf = Sharding(mesh, ("file", "channel", None)).gather(trf)[0]
    del trf
    if spec.get("full_outputs"):
        sh4 = Sharding(mesh, (None, "file", "channel", None))
        out["trf"] = g_trf.cpu().numpy()
        out["corr"] = sh4.gather(corr)[:, 0].cpu().numpy()
        out["env"] = sh4.gather(env)[:, 0].cpu().numpy()
    del corr, env
    if spec.get("against_filter_block") and mesh.rank == 0:
        det = MatchedFilterDetector.from_design(design, spec["metadata"], wire="raw",
                                                device=dev)
        ref = det.filter_block(torch.as_tensor(np.asarray(raw)).to(dev))
        scale = float(ref.abs().max())
        out["trf_rel"] = float((g_trf - ref).abs().max()) / scale
        _RANK_DET["det"] = det             # item 2's one-card filter, built once
        del ref, det
    del g_trf, x
    if on_card:
        torch.cuda.empty_cache()
    return out


def _rank_item_nccl(spec, rank):
    """Item 2: the same step on a one-rank NCCL group, on rank 0 (rank 1
    builds the group with it, as ``new_group`` asks, and waits)."""
    import torch
    import torch.distributed as dist

    from das4whales_tpu_torch.ops import fused_picks
    from das4whales_tpu_torch.parallel import collectives as coll
    from das4whales_tpu_torch.parallel.mesh import make_mesh
    from das4whales_tpu_torch.parallel.pipeline import make_sharded_mf_step
    from das4whales_tpu_torch.utils.checkpoint import load_design
    from das4whales_tpu_torch.workflows import campaign as cmod

    group = dist.new_group([0], backend="nccl")
    out = {}
    if rank == 0:
        design = load_design(spec["design"])
        mesh = make_mesh((1, 1), ("file", "channel"), devices=[spec["device"]],
                         backend="nccl", group=group)
        x = torch.as_tensor(np.load(spec["raw"])[None]).to(spec["device"])
        k0, full = cmod._adaptive_sharded_steps(make_sharded_mf_step, design, mesh,
                                                wire="raw", scale_factor=spec["scale_factor"])
        k0(x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        coll.reset_stats()
        fused_picks.launches = 0
        with _capture(fused_picks, "picks_cuda") as calls:
            t0 = time.perf_counter()
            sp, thres, esc = cmod._run_adaptive(k0, full, x, mesh)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = fused_picks.launches
        stats = coll.read_stats()
        err, rows = _rank_kernel_check(calls)
        out = dict(picks=_rank_picks(sp, design.trace_shape[1], design.template_names, 0)[0],
                   thres=thres.cpu().numpy(), escalated=esc, launches=launches,
                   attempts=1 + int(esc), kernel_err=err, kernel_rows=rows, wall=wall,
                   stats=stats, peak=torch.cuda.max_memory_allocated(),
                   backend=mesh.backend)
        del sp
        out["apart"] = _rank_where_apart(spec, design, mesh, k0, x)
        del x
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def _rank_where_apart(spec, design, mesh, step, x) -> dict:
    """Where the one-rank step's filter parts from the one-card
    detector's, on the same block: the conditioning, the f-k transform
    on the detector's own band and mask, and the step's band (its mask
    carries the bandpass gain before the band crop, the detector's after)."""
    import torch

    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.ops import conditioning as cond_ops
    from das4whales_tpu_torch.ops.fk import fk_filter_apply_rfft_banded
    from das4whales_tpu_torch.parallel.fft import fk_apply_local_banded

    det = _RANK_DET.pop("det", None)
    if det is None:
        det = MatchedFilterDetector.from_design(design, spec["metadata"], wire="raw",
                                                device=spec["device"])
    xc = det.condition_input(x[0])
    cond = cond_ops.condition(x, spec["scale_factor"], dtype=torch.float32)[0]
    lo, hi = det._band_lo, det._band_hi
    one = fk_filter_apply_rfft_banded(xc, det._mask_band, lo, hi)
    same = fk_apply_local_banded(xc[None], det._mask_band, lo, hi, "channel", mesh=mesh)[0]
    s_lo, s_hi = step.band
    own = fk_apply_local_banded(xc[None], step.mask_band, s_lo, s_hi, "channel", mesh=mesh)[0]
    scale = float(one.abs().max())
    res = dict(cond_bitwise=bool(torch.equal(cond, xc)),
               transform_bitwise=bool(torch.equal(same, one)),
               transform_rel=float((same - one).abs().max()) / scale,
               band_one=[lo, hi], band_step=[s_lo, s_hi],
               crop_rel=float((own - one).abs().max()) / scale,
               fk_engine=det.fk_engine)
    del det, xc, cond, one, same, own
    return res


def _rank_sync(spec) -> None:
    import torch

    if spec["device"].startswith("cuda"):
        torch.cuda.synchronize()


def _rank_reset(spec) -> None:
    import torch

    if spec["device"].startswith("cuda"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _rank_peak(spec) -> int:
    import torch

    return torch.cuda.max_memory_allocated() if spec["device"].startswith("cuda") else 0


def _rank_item_long(spec, rank):
    """Item 3: the long record over a (time=2) mesh: the fused bandpass on
    the conditioned wire, then the halo bandpass on the raw wire."""
    from das4whales_tpu_torch.ops import fused_picks
    from das4whales_tpu_torch.parallel import collectives as coll
    from das4whales_tpu_torch.parallel import timeshard
    from das4whales_tpu_torch.parallel.mesh import make_mesh
    from das4whales_tpu_torch.utils.checkpoint import load_design
    from das4whales_tpu_torch.workflows.longrecord import detect_long_record

    mesh = make_mesh((MESH_RANKS,), ("time",), devices=[spec["device"]] * MESH_RANKS,
                     backend="gloo")
    t0 = time.perf_counter()
    design = load_design(spec["long_design"])
    t_load = time.perf_counter() - t0
    out = {"design_load_s": t_load}
    halo_design = load_design(spec["halo_design"])
    for name, kw in (("fused", dict(wire="conditioned", engine="native", design=design,
                                    selected_channels=spec["long_sel"])),
                     ("halo", dict(wire="raw", fused_bandpass=False, engine="native",
                                   design=halo_design, selected_channels=spec["halo_sel"]))):
        _rank_reset(spec)
        coll.reset_stats()
        fused_picks.launches = 0
        timer = StageTimer() if spec["device"].startswith("cuda") else None
        with _capture(fused_picks, "picks_cuda") as calls:
            t0 = time.perf_counter()
            res = detect_long_record(spec["long_files"], interrogator="silixa", mesh=mesh,
                                     stage_hook=timer, **kw)
            _rank_sync(spec)
            wall = time.perf_counter() - t0
        out[name] = dict(picks=res.picks, thresholds=res.thresholds, n_samples=res.n_samples,
                         wall=wall, stages=timer.walls() if timer is not None else {},
                         stats=coll.read_stats(), peak=_rank_peak(spec),
                         launches=fused_picks.launches, t0=str(res.t0_utc),
                         route=timeshard.pick_route(res.n_samples, 512, "topk", mesh.device))
        if calls["n"]:
            out[name]["kernel_err"], out[name]["kernel_rows"] = _rank_kernel_check(calls)
        del calls
    return out


def _rank_filtered(spec, wire: str, block, dev):
    """The canonical design's prefilter (``filter_block``) of a host block
    on ``dev``: the input the spectro and Gabor families take."""
    import torch

    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.utils.checkpoint import load_design

    det = MatchedFilterDetector.from_design(load_design(spec["design"]), spec["metadata"],
                                            wire=wire, device=dev)
    return det.filter_block(torch.from_numpy(np.array(block)).to(dev))


def _rank_gather_picks(mesh, picks: dict, names) -> dict:
    """Every rank's ``{name: (2, n)}`` picks (channel offsets applied),
    joined in mesh rank order."""
    from das4whales_tpu_torch.parallel import collectives as coll

    parts = coll.all_gather_object(picks, mesh)
    return {name: np.concatenate([p[name] for p in parts], axis=1) for name in names}


def _rank_item_spectro(spec, rank):
    """Item 6: ``make_sharded_spectro_step`` at (file=1, channel=2) on the
    prefiltered canonical block, this rank's ``fused_stft`` launches
    counted and its first and last held against the plain version."""
    import torch

    from das4whales_tpu_torch.ops import fused_stft
    from das4whales_tpu_torch.parallel.mesh import make_mesh
    from das4whales_tpu_torch.parallel.pipeline import input_sharding
    from das4whales_tpu_torch.parallel.spectro import make_sharded_spectro_step

    dev = spec["device"]
    mesh = make_mesh((1, MESH_RANKS), ("file", "channel"), devices=[dev] * MESH_RANKS,
                     backend="gloo")
    trf = _rank_filtered(spec, "raw", np.load(spec["raw"], mmap_mode="r"), dev)
    x = input_sharding(mesh).place(trf[None]).clone()
    del trf
    step, names = make_sharded_spectro_step(spec["metadata"], mesh, outputs="picks",
                                            channel_tile=MESH_SPECTRO_TILE)
    step(x)                                  # warm-up: cuFFT plans, the kernel's load
    _rank_reset(spec)
    fused_stft.launches = 0                  # the main path's run starts here
    with _capture(fused_stft, "stft_power_cuda") as calls:
        t0 = time.perf_counter()
        sp = step(x)
        _rank_sync(spec)
        wall = time.perf_counter() - t0
    launches = fused_stft.launches
    c_local = x.shape[1]
    n_frames = 1 + x.shape[-1] // 8
    out = dict(launches=launches, wall=wall, peak=_rank_peak(spec))
    if x.is_cuda:
        out["rows"] = [int(calls[w][0][0].shape[0]) for w in ("first", "last")]
        out["err"], out["rel"], _ = _stft_at_main_path(
            f"mesh: spectro rank {rank}", calls, (MESH_SPECTRO_TILE, x.shape[-1]))
    del calls
    local = _rank_picks(sp, n_frames, names, mesh.axis_index("channel") * c_local)[0]
    out["picks"] = _rank_gather_picks(mesh, local, names)
    del sp, x
    _rank_reset(spec)
    return out


def _gabor_design(meta, nx: int):
    from das4whales_tpu_torch.models.gabor import design_gabor

    return design_gabor(meta, [0, nx, 1], threshold1=GABOR_THRESHOLDS[0],
                        threshold2=GABOR_THRESHOLDS[1])


def _rank_item_gabor(spec, rank):
    """Item 7: ``make_sharded_gabor_step`` at (file=2) on two prefiltered
    slab files, each rank reading and filtering only its own (its slot of
    ``gabor_input_sharding``), one ``fused_picks`` launch a rank held
    bitwise against the plain version."""
    import torch

    from das4whales_tpu_torch.io.stream import stream_strain_blocks
    from das4whales_tpu_torch.ops import fused_picks
    from das4whales_tpu_torch.parallel.gabor import make_sharded_gabor_step
    from das4whales_tpu_torch.parallel.mesh import make_mesh

    dev = spec["device"]
    mesh = make_mesh((MESH_RANKS,), ("file",), devices=[dev] * MESH_RANKS, backend="gloo")
    path = spec["camp_files"][mesh.axis_index("file")]
    blk = next(stream_strain_blocks([path], spec["camp_sel"], interrogator="silixa",
                                    as_numpy=True, engine="native"))
    x = _rank_filtered(spec, "conditioned", blk.trace, dev)[None]
    meta = blk.metadata
    del blk
    step, names = make_sharded_gabor_step(meta, spec["camp_sel"], mesh,
                                          design=_gabor_design(meta, x.shape[1]))
    step(x)                                  # warm-up
    _rank_reset(spec)
    fused_picks.launches = 0
    with _capture(fused_picks, "picks_cuda") as calls:
        t0 = time.perf_counter()
        corr, sp, thres = step(x)
        _rank_sync(spec)
        wall = time.perf_counter() - t0
    del corr
    launches = fused_picks.launches
    out = dict(path=path, launches=launches, wall=wall, peak=_rank_peak(spec),
               thres=float(thres[0]), picks=_rank_picks(sp, x.shape[-1], names, 0)[0])
    if x.is_cuda:
        out["kernel_err"], out["kernel_rows"] = _rank_kernel_check(calls)
    del calls, sp, x
    _rank_reset(spec)
    return out


def _rank_long_family(spec, mesh, **kw) -> dict:
    """One long record over ``mesh`` (the native reader), its picks, walls,
    collectives and peak, and the pick kernel's launches held bitwise."""
    from das4whales_tpu_torch.ops import fused_picks, fused_stft
    from das4whales_tpu_torch.parallel import collectives as coll
    from das4whales_tpu_torch.workflows.longrecord import detect_long_record

    _rank_reset(spec)
    coll.reset_stats()
    fused_picks.launches = fused_stft.launches = 0
    timer = StageTimer() if spec["device"].startswith("cuda") else None
    with _capture(fused_picks, "picks_cuda") as calls:
        t0 = time.perf_counter()
        res = detect_long_record(spec["long_files"], interrogator="silixa", mesh=mesh,
                                 engine="native", stage_hook=timer, **kw)
        _rank_sync(spec)
        wall = time.perf_counter() - t0
    out = dict(picks=res.picks, thresholds=res.thresholds, n_samples=res.n_samples, wall=wall,
               stages=timer.walls() if timer is not None else {}, stats=coll.read_stats(),
               peak=_rank_peak(spec), launches=fused_picks.launches,
               stft_launches=fused_stft.launches)
    if calls["n"]:
        out["kernel_err"], out["kernel_rows"] = _rank_kernel_check(calls)
    return out


def _rank_time_mesh(spec):
    from das4whales_tpu_torch.parallel.mesh import make_mesh

    return make_mesh((MESH_RANKS,), ("time",), devices=[spec["device"]] * MESH_RANKS,
                     backend="gloo")


def _rank_item_learned_long(spec, rank):
    """Item 8: the learned long record over the mesh at full width: the
    record channel-sharded over (channel=2) (``make_sharded_inference``)."""
    from das4whales_tpu_torch.models import learned as lmod

    model, cfg = lmod.load_pretrained()
    return _rank_long_family(spec, _rank_time_mesh(spec), selected_channels=spec["long_sel"],
                             family="learned", family_kwargs={"params": model, "cfg": cfg})


def _rank_item_spectro_long(spec, rank):
    """Item 9: the spectro long record over (time=2) on the channel cut."""
    from das4whales_tpu_torch.utils.checkpoint import load_design

    return _rank_long_family(spec, _rank_time_mesh(spec), selected_channels=spec["spectro_sel"],
                             family="spectro", design=load_design(spec["spectro_design"]))


def _rank_item_gabor_long(spec, rank):
    """Item 10: the Gabor long record over (time=2) on the first rows."""
    from das4whales_tpu_torch.utils.checkpoint import load_design

    return _rank_long_family(spec, _rank_time_mesh(spec), selected_channels=spec["gabor_sel"],
                             family="gabor", design=load_design(spec["gabor_design"]))


def _rank_item_campaign(spec, rank):
    """Item 4: ``run_campaign_sharded`` at (file=2, channel=1) over the four
    canonical slab files, then the same call again (resume)."""
    from das4whales_tpu_torch.ops import fused_picks
    from das4whales_tpu_torch.parallel import collectives as coll
    from das4whales_tpu_torch.parallel.mesh import make_mesh
    from das4whales_tpu_torch.workflows import campaign as cmod

    mesh = make_mesh((MESH_RANKS, 1), ("file", "channel"), devices=[spec["device"]] * MESH_RANKS,
                     backend="gloo")
    reads = {"n": 0}
    orig = cmod._read_local

    def counted(*a, **k):
        reads["n"] += 1
        return orig(*a, **k)

    cmod._read_local = counted
    _rank_reset(spec)
    coll.reset_stats()
    fused_picks.launches = 0
    t0 = time.perf_counter()
    res = cmod.run_campaign_sharded(spec["camp_files"], spec["camp_sel"], spec["camp_out"],
                                    mesh, interrogator="silixa", design=spec["design"],
                                    engine="native")
    _rank_sync(spec)
    wall = time.perf_counter() - t0
    out = dict(records=[(r.path, r.status, r.rung, r.picks_file) for r in res.records],
               wall=wall, reads=reads["n"], launches=fused_picks.launches,
               stats=coll.read_stats(), peak=_rank_peak(spec))
    reads["n"] = 0
    t0 = time.perf_counter()
    again = cmod.run_campaign_sharded(spec["camp_files"], spec["camp_sel"], spec["camp_out"],
                                      mesh, interrogator="silixa", design=spec["design"],
                                      engine="native")
    out.update(resume=[r.status for r in again.records], resume_reads=reads["n"],
               resume_wall=time.perf_counter() - t0)
    cmod._read_local = orig
    return out


def _rank_item_elastic(spec, rank):
    """Item 11, the elastic drill (a pool of its own): ``run_campaign_sharded
    (elastic=True)`` at (file=1, channel=2) over the slab files at
    ``MESH_CLI_CHANNELS`` channels, batches of two; rank 1 dies
    (``os._exit``) as its second batch starts, and rank 0 carries on. The
    survivor check-in waits ``MESH_ELASTIC_GROUP_TIMEOUT_S +
    MESH_ELASTIC_DEADLINE_S`` for the dead rank."""
    from das4whales_tpu_torch.parallel.mesh import make_mesh
    from das4whales_tpu_torch.utils import artifacts
    from das4whales_tpu_torch.workflows import campaign as cmod

    mesh = make_mesh((1, MESH_RANKS), ("file", "channel"), devices=[spec["device"]] * MESH_RANKS,
                     backend="gloo")
    cmod._DEVICE_PROBE_DEADLINE_S = MESH_ELASTIC_DEADLINE_S
    orig, batches = cmod._run_adaptive, {"n": 0}

    def victim(*a, **k):
        batches["n"] += 1
        if batches["n"] == 2 and rank == 1:
            say("mesh rank 1: the elastic drill's victim exits")
            os._exit(3)
        return orig(*a, **k)

    cmod._run_adaptive = victim
    t0 = time.perf_counter()
    res = cmod.run_campaign_sharded(spec["camp_files"], [0, MESH_CLI_CHANNELS, 1],
                                    spec["elastic_out"], mesh, interrogator="silixa",
                                    engine="native", batch=2)
    _rank_sync(spec)
    return dict(records=[(r.path, r.status, r.rung, r.picks_file) for r in res.records],
                wall=time.perf_counter() - t0, batches=batches["n"],
                events=[e for e in artifacts.read_records(cmod._manifest_path(spec["elastic_out"]))
                        if "event" in e and "path" not in e])


MESH_ITEMS = {"step": _rank_item_step, "nccl": _rank_item_nccl, "long": _rank_item_long,
              "campaign": _rank_item_campaign, "spectro": _rank_item_spectro,
              "gabor": _rank_item_gabor, "learned_long": _rank_item_learned_long,
              "spectro_long": _rank_item_spectro_long, "gabor_long": _rank_item_gabor_long,
              "elastic": _rank_item_elastic}
#: the family items (ROADMAP 14b), budgeted apart from items 1-5
MESH_FAMILY_ITEMS = ("spectro", "gabor", "learned_long", "spectro_long", "gabor_long")


def mesh_rank_main(spec_path: str, rank: int) -> int:
    """One rank of a mesh phase (``chip_smoke.py --mesh-rank SPEC RANK``):
    the gloo group through the spec's file rendezvous, every item of the
    spec in order, the results pickled beside the spec. A rank without
    its card exits 1: no rank carries on on the CPU."""
    import pickle

    import torch

    from das4whales_tpu_torch.parallel import collectives as coll
    from das4whales_tpu_torch.parallel import distributed

    with open(spec_path, "rb") as fh:
        spec = pickle.load(fh)
    if spec["device"].startswith("cuda") and not torch.cuda.is_available():
        fail(f"mesh rank {rank}: no CUDA device; a rank never carries on on the CPU")
    torch.set_num_threads(spec.get("threads", 2))
    distributed.initialize(spec["init"], spec["world"], rank, backend="gloo",
                           timeout_s=spec.get("group_timeout_s", MESH_GROUP_TIMEOUT_S))
    coll.timing(spec["device"].startswith("cuda"))
    ready = spec.get("ready")
    t0 = time.perf_counter()
    while ready and not os.path.exists(ready):
        if time.perf_counter() - t0 > MESH_READY_TIMEOUT_S:
            fail(f"mesh rank {rank}: the inputs were not ready in {MESH_READY_TIMEOUT_S:.0f} s")
        time.sleep(0.2)
    out = {}
    for item in spec["items"]:
        t0 = time.perf_counter()
        out[item] = MESH_ITEMS[item](spec, rank)
        out[item]["item_s"] = time.perf_counter() - t0
        say(f"mesh rank {rank}: {item} done in {out[item]['item_s']:.1f} s")
        if spec["device"].startswith("cuda"):
            # the pools and the main process's references share one card: a
            # rank's cache between items is memory its peers may need
            torch.cuda.empty_cache()
    with open(os.path.join(os.path.dirname(spec_path), f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)
    import torch.distributed as dist

    if dist.is_initialized():    # the elastic drill's survivor ends on a mesh of one
        dist.destroy_process_group()
    return 0


def _mesh_pool(d, spec: dict, tag: str) -> tuple:
    """Start ``spec["world"]`` rank processes of this script (``--mesh-rank``)
    under ``d``, each logging to ``rank<r>.log``; returns ``(procs, logs,
    spec path)`` for :func:`_mesh_wait`."""
    import pickle

    d.mkdir(parents=True, exist_ok=True)
    spec = dict(spec, init=f"file://{d}/rendezvous")
    spec_path = str(d / "spec.pkl")
    with open(spec_path, "wb") as fh:
        pickle.dump(spec, fh)
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    procs, logs = [], []
    for r in range(spec["world"]):
        log = open(d / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-rank",
                                       spec_path, str(r)], stdout=log,
                                      stderr=subprocess.STDOUT, env=env,
                                      cwd=str(_root_dir())))
    return procs, logs, spec_path, tag


def _root_dir():
    from pathlib import Path

    return Path(__file__).resolve().parent


def _mesh_wait(pool, expect_rc: dict | None = None) -> list:
    """Wait for a pool's ranks; a rank that exits otherwise than
    ``expect_rc`` says (0 by default), or outlives
    :data:`MESH_POOL_TIMEOUT_S`, fails the phase, naming the rank and its
    log. Every rank is stopped on the way out. Returns each rank's
    results (``{}`` for a rank expected to die)."""
    import pickle

    procs, logs, spec_path, tag = pool
    deadline = time.monotonic() + MESH_POOL_TIMEOUT_S
    rcs = []
    try:
        for p in procs:
            try:
                rcs.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                rcs.append(None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    d = os.path.dirname(spec_path)
    for r, rc in enumerate(rcs):
        if rc != (expect_rc or {}).get(r, 0):
            path = os.path.join(d, f"rank{r}.log")
            with open(path) as fh:
                tail = fh.read()[-4000:]
            fail(f"{tag}: rank {r} exited {rc if rc is not None else 'by the launcher (timeout)'}"
                 f"; its log {path}:\n{tail}")
    out = []
    for r in range(len(procs)):
        if r in (expect_rc or {}):
            out.append({})
            continue
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as fh:
            out.append(pickle.load(fh))
    return out


def _stats_text(stats: dict) -> str:
    """A rank's collectives: calls, bytes, wall and the host-staging share."""
    parts = []
    for name, s in sorted(stats.items()):
        share = (100 * s["stage_seconds"] / s["seconds"]) if s["seconds"] else 0.0
        parts.append(f"{name} {s['calls']}x {s['bytes'] / 1e6:.1f} MB sent, "
                     f"{s['staged_bytes'] / 1e6:.1f} MB staged, {s['seconds'] * 1e3:.1f} ms "
                     f"({share:.0f} % staging)")
    return "; ".join(parts) or "none"


def _cli_sharded(d, path: str, out: dict) -> None:
    """Item 5 on a thread: ``campaign --sharded`` without rank variables (a
    mesh of one on the card) at ``MESH_CLI_CHANNELS`` channels, designing
    in-process."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "das4whales_tpu_torch", "campaign", path,
                           "--interrogator", "silixa", "--channels",
                           f"0,{MESH_CLI_CHANNELS},1", "--no-figure", "--sharded",
                           "--outdir", str(d / "cli_sharded")],
                          cwd=str(_root_dir()), env=env, capture_output=True, text=True,
                          timeout=600)
    out["sharded"] = (proc.returncode, proc.stdout, proc.stderr, time.perf_counter() - t0)


def _mesh_references(out: dict, design, raw, scene, camp_files) -> None:
    """The single-card references the mesh items are held to, computed on
    the card beside the ranks (a thread): ``detect_picks`` on the raw
    canonical block and its envelopes (items 1, 2), each campaign file's
    ``detect_picks`` at its own shape with its envelopes (item 4, the
    native reader as the ranks'), and the one-card long record's envelopes
    (item 3). Errors land in ``out["error"]``."""
    import torch

    from das4whales_tpu_torch.io.stream import stream_strain_blocks
    from das4whales_tpu_torch.models.matched_filter import (
        MatchedFilterDetector,
        design_matched_filter,
    )
    from das4whales_tpu_torch.utils.parity import envelopes

    t0 = time.perf_counter()
    try:
        det = MatchedFilterDetector.from_design(design, scene.metadata, wire="raw")
        x = torch.as_tensor(raw).to("cuda")
        out.update(ref=det.detect_picks(x), env=envelopes(det, x))
        del x
        torch.cuda.empty_cache()     # the ranks share the card
        det_c = MatchedFilterDetector.from_design(design, scene.metadata, wire="conditioned")
        out["camp"] = {}
        for blk in stream_strain_blocks(camp_files[:MESH_CAMPAIGN_FILES], [0, CANONICAL[0], 1],
                                        interrogator="silixa",
                                        as_numpy=True, engine="native"):
            path = camp_files[len(out["camp"])]
            xb = torch.as_tensor(blk.trace).to("cuda")
            one = det_c.detect_picks(xb)
            out["camp"][path] = (one.picks, one.thresholds, envelopes(det_c, xb))
            del xb
        torch.cuda.empty_cache()
        out["long_env"] = _LONG_REF["env_fn"]()
        torch.cuda.empty_cache()
        # item 5's selection, conditioned as the command reads it (its
        # default reader, the format one)
        sel = [0, MESH_CLI_CHANNELS, 1]
        blk = next(stream_strain_blocks(camp_files[:1], sel, interrogator="silixa",
                                        as_numpy=True, engine="h5py"))
        dc = design_matched_filter((MESH_CLI_CHANNELS, CANONICAL[1]), sel, blk.metadata)
        dcli = MatchedFilterDetector.from_design(dc, blk.metadata, wire="conditioned")
        xc = torch.as_tensor(blk.trace).to("cuda")
        one = dcli.detect_picks(xc)
        out.update(cli_one=(one.picks, one.thresholds), cli_env=envelopes(dcli, xc))
        del xc
        # item 11's references: each slab file at those channels, the native
        # reader as the drill's ranks read it
        out["elastic"] = {}
        for k, blk in enumerate(stream_strain_blocks(camp_files, sel, interrogator="silixa",
                                                     as_numpy=True, engine="native")):
            xb = torch.as_tensor(blk.trace).to("cuda")
            one = dcli.detect_picks(xb)
            out["elastic"][camp_files[k]] = (one.picks, one.thresholds, envelopes(dcli, xb))
            del xb
        del dcli
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        _family_references(out, det, det_c, raw, scene, camp_files)
    except Exception as exc:  # noqa: BLE001 — re-raised by phase_mesh after the pool
        out["error"] = f"{type(exc).__name__}: {exc}"
    out["seconds"] = time.perf_counter() - t0


def _family_references(out: dict, det, det_c, raw, scene, camp_files) -> None:
    """The one-card references of the family items (6-10), beside the
    ranks: the ``SpectroCorrDetector`` on the prefiltered canonical block
    (its correlograms kept for the margin), ``GaborDetector`` on each of
    the two prefiltered slab files, the learned record's rFFT-feature
    scores on one card (``make_sharded_inference`` on a mesh of one), and
    the spectro and Gabor long records on a mesh of one on the card with
    their margins (``detect_long_record(keep_envelopes=True)``). The Gabor
    files' margins are closures, run only where picks differ."""
    import torch

    from das4whales_tpu_torch.io.stream import stream_strain_blocks
    from das4whales_tpu_torch.models import learned as lmod
    from das4whales_tpu_torch.models.gabor import GaborDetector
    from das4whales_tpu_torch.models.spectro import SpectroCorrDetector
    from das4whales_tpu_torch.ops import spectral
    from das4whales_tpu_torch.parallel.mesh import make_mesh
    from das4whales_tpu_torch.workflows.longrecord import detect_long_record

    meta, nx = scene.metadata, CANONICAL[0]
    x = torch.as_tensor(raw).to("cuda")
    corr, picks, _ = SpectroCorrDetector(meta)(det.filter_block(x))
    out["spectro"] = (picks, {k: v.cpu().numpy() for k, v in corr.items()})
    del x, corr
    out["gabor"] = {}
    for blk in stream_strain_blocks(camp_files[:MESH_RANKS], [0, nx, 1], interrogator="silixa",
                                    as_numpy=True, engine="native"):
        path = camp_files[len(out["gabor"])]
        gdet = GaborDetector(blk.metadata, [0, nx, 1], design=_gabor_design(blk.metadata, nx))

        def env_fn(trace=blk.trace, gdet=gdet):
            g = gdet(det_c.filter_block(torch.as_tensor(trace).to("cuda")))
            return np.stack([spectral.envelope_sqrt(c).cpu().numpy()
                             for c in g["correlograms"].values()])

        g = gdet(det_c.filter_block(torch.as_tensor(blk.trace).to("cuda")))
        out["gabor"][path] = (g["picks"], g["thresholds"], env_fn)
        del g
    torch.cuda.empty_cache()
    lr = _LONG_REF
    blocks = list(stream_strain_blocks(lr["paths"], [0, nx, 1], interrogator="silixa",
                                       as_numpy=True, engine="native"))
    record = np.concatenate([b.trace for b in blocks], axis=-1)
    del blocks
    model, cfg = lmod.load_pretrained()
    score_fn, _ = lmod.make_sharded_inference(
        model, cfg, make_mesh(shape=(1,), axis_names=("channel",), devices=["cuda:0"]))
    # in channel blocks (scores are per channel): the rFFT features of the
    # whole record would take tens of GB beside the ranks
    scores = np.concatenate([score_fn(torch.from_numpy(record[i:i + 4096]).to("cuda"))
                             .cpu().numpy() for i in range(0, record.shape[0], 4096)])
    ldet = lmod.LearnedDetector(model, cfg, device="cpu")
    pk = ldet.picks_from_scores(scores).picks[ldet.name]
    out["learned_long"] = (pk[:, pk[1] < record.shape[-1]], scores,
                           lmod.window_centers(scores.shape[1], cfg))
    torch.cuda.empty_cache()
    for fam, sel_key, design_key in (("spectro", "spectro_sel", "spectro_design"),
                                     ("gabor", "gabor_sel", "gabor_design")):
        sel, design = lr[sel_key], lr[design_key]
        # the margin from the same run, beside the ranks, rather than after the pool
        res = detect_long_record(lr["paths"], sel, interrogator="silixa", family=fam,
                                 design=design, engine="native", keep_envelopes=True)
        margin = (list(res.thresholds), res.envelopes, res.pos_scale, res.thresholds)
        out[f"{fam}_long"] = (res.picks, res.thresholds, lambda m=margin: m)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _done_picks(outdir: str) -> tuple:
    """``(picks, thresholds)`` of the one ``done`` record of a campaign
    outdir."""
    from das4whales_tpu_torch.utils import artifacts
    from das4whales_tpu_torch.workflows import campaign as cmod

    recs = [r for r in artifacts.read_records(cmod._manifest_path(outdir))
            if r.get("status") == "done"]
    if len(recs) != 1:
        fail(f"mesh: {outdir} holds {len(recs)} done records, expected 1")
    with np.load(recs[0]["picks_file"]) as z:
        thr = dict(zip(z["template_names"].tolist(), z["thresholds"].tolist()))
    return cmod.load_picks(recs[0]["picks_file"]), thr


def phase_mesh(scene=None, raw=None, design=None):
    """The matched filter over a device mesh on the card (module
    docstring, phase 35): two ranks sharing the card over gloo, items 1-4
    in one pool of ranks, item 5 (the command line) on a thread beside
    them. Returns ``({path: launches}, max_abs_err)``."""
    import shutil
    import tempfile
    import threading
    from pathlib import Path

    import torch

    from das4whales_tpu_torch import fsck
    from das4whales_tpu_torch.utils.checkpoint import save_design
    from das4whales_tpu_torch.workflows import campaign as cmod

    t_phase = time.perf_counter()
    nx, ns = CANONICAL
    root = _root_dir() / "build"
    root.mkdir(exist_ok=True)
    d = Path(tempfile.mkdtemp(prefix="mesh_", dir=root))
    if scene is None or not _LONG_REF or "paths" not in _SHARED:
        # run alone (--only): the canonical scene and design, the slab files
        # and the long record's files and design, made here at once
        canonical = _mesh_alone(d, scene is None)
        if scene is None:
            scene, raw, design = canonical
        t_phase = time.perf_counter()
    try:
        shared = slab_files()
        camp_files = [p for p, (_, fns) in zip(shared["paths"], SLAB_FILES)
                      if fns == CANONICAL[1]]
        ch_s = _LONG_REF["ch_s"]
        h0 = ch_s - MESH_HALO_CHANNELS // 2
        spec = dict(world=MESH_RANKS, device="cuda:0", threads=3,
                    items=["step", "nccl", "long", "campaign", *MESH_FAMILY_ITEMS],
                    design=str(d / "design.npz"),
                    raw=str(d / "raw.npy"), scale_factor=scene.metadata.scale_factor,
                    metadata=scene.metadata, against_filter_block=True,
                    long_design=_LONG_REF["design_paths"]["long"],
                    halo_design=_LONG_REF["design_paths"]["halo"], long_files=_LONG_REF["paths"],
                    long_sel=[0, nx, 1], halo_sel=[h0, h0 + MESH_HALO_CHANNELS, 1],
                    camp_files=camp_files[:MESH_CAMPAIGN_FILES], camp_sel=[0, nx, 1],
                    camp_out=str(d / "camp"),
                    spectro_design=_LONG_REF["design_paths"]["spectro"],
                    gabor_design=_LONG_REF["design_paths"]["gabor"],
                    spectro_sel=_LONG_REF["spectro_sel"], gabor_sel=_LONG_REF["gabor_sel"],
                    ready=str(d / "ready"))
        # the ranks start (import, group, meshes) while their inputs are
        # written; this process's cache goes back to the card they share
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        pool = _mesh_pool(d / "pool", spec, "mesh")
        # item 11, the elastic drill: a pool of its own beside the main one
        epool = _mesh_pool(d / "elastic_pool", dict(
            world=MESH_RANKS, device="cuda:0", threads=1, items=["elastic"],
            group_timeout_s=MESH_ELASTIC_GROUP_TIMEOUT_S,
            camp_files=camp_files, elastic_out=str(d / "elastic")), "mesh (elastic drill)")
        cli = {}
        th = threading.Thread(target=_cli_sharded, args=(d, camp_files[0], cli), daemon=True)
        th.start()
        t_designs = _long_designs()
        np.save(d / "raw.npy", raw)
        save_design(spec["design"], design)
        (d / "ready").touch()
        t_prep = time.perf_counter() - t0
        # the one-card references, computed on the card beside the ranks
        refs = {}
        rth = threading.Thread(target=_mesh_references,
                               args=(refs, design, raw, scene, camp_files), daemon=True)
        rth.start()
        ranks = _mesh_wait(pool)
        t_pool = time.perf_counter() - t0
        rth.join()
        t_refs_wait = time.perf_counter() - t0 - t_pool
        t_checks0 = time.perf_counter()
        if "error" in refs:
            fail(f"mesh: the one-card references failed: {refs['error']}")
        ref = refs["ref"]
        launches, err = {}, 0.0

        def env_canonical():
            return refs["env"]

        # item 1: two ranks over gloo
        st = [rk["step"] for rk in ranks]
        n_tiles = -(-(nx // MESH_RANKS) // 512)
        for r, s in enumerate(st):
            if s["launches"] != n_tiles * s["attempts"]:
                fail(f"mesh: rank {r} launched fused_picks {s['launches']} times in "
                     f"{s['attempts']} attempts, expected {n_tiles} an attempt")
            if s["kernel_rows"] != [2 * 512, 2 * (nx // MESH_RANKS - (n_tiles - 1) * 512)]:
                fail(f"mesh: rank {r} first/last pick launches of {s['kernel_rows']} rows")
            err = max(err, s["kernel_err"])
            launches[f"mesh_gloo_rank{r}"] = s["launches"]
        if st[0]["escalated"] != st[1]["escalated"]:
            fail("mesh: the ranks' escalation decisions differ")
        for name, t in ref.thresholds.items():
            i = design.template_names.index(name)
            got = float(st[0]["thres"][0]) * float(design.threshold_factors[i])
            if abs(got - t) > MESH_THR_RTOL * abs(t):
                fail(f"mesh: gloo {name} threshold {got} against detect_picks' {t}")
        thr = ref.thresholds
        n_gloo = _same_picks("mesh: gloo picks against detect_picks", ref.picks,
                             st[0]["picks"], env_canonical, thr)
        for r in range(MESH_RANKS):
            for name in ref.picks:
                if not np.array_equal(st[r]["picks"][name], st[0]["picks"][name]):
                    fail(f"mesh: rank {r}'s gathered {name} picks differ from rank 0's")
        if st[0]["trf_rel"] > MESH_REL:
            fail(f"mesh: the gathered trf_fk is {st[0]['trf_rel']:.2e} * max from "
                 f"filter_block's (limit {MESH_REL})")
        misses = _check_calls(scene, st[0]["picks"])
        if misses:
            fail(f"mesh: gloo: injected calls missed {misses}")
        say(
            f"mesh: item 1, two ranks on cuda:0 over gloo, mesh (file=1, channel=2), raw int32 "
            f"{nx}x{ns} ({nx // MESH_RANKS} channels a rank), the adaptive pair (pack K0=64, "
            f"topk K=256 on a mesh-wide saturation): {st[0]['attempts']} attempt(s), walls "
            f"{', '.join(f'{s['wall'] * 1e3:.1f}' for s in st)} ms (ranks sharing the card), "
            f"fused_picks launches {[s['launches'] for s in st]} ({n_tiles} an attempt), each "
            f"rank's first and last launch ({st[0]['kernel_rows']} rows) bitwise the plain "
            f"version; picks against detect_picks: "
            f"{'equal' if n_gloo == 0 else f'{n_gloo} apart on knife edges'}; thresholds "
            f"within rtol {MESH_THR_RTOL}; outputs='full' trf_fk gathered within "
            f"{st[0]['trf_rel']:.2e} * max of filter_block's; collectives rank 0: "
            f"{_stats_text(st[0]['stats'])}; the full step's: "
            f"{_stats_text(st[0]['full_stats'])}; peak memory a rank "
            f"{[round(s['peak'] / 2**30, 2) for s in st]} GiB; item {st[0]['item_s']:.1f} s")
        # item 2: the one-rank NCCL group
        nc = ranks[0]["nccl"]
        n_tiles_full = -(-nx // 512)
        if nc["launches"] != n_tiles_full * nc["attempts"] or nc["backend"] != "nccl":
            fail(f"mesh: nccl: {nc['launches']} launches in {nc['attempts']} attempts "
                 f"(backend {nc['backend']})")
        err = max(err, nc["kernel_err"])
        launches["mesh_nccl"] = nc["launches"]
        bitwise = all(np.array_equal(nc["picks"][n], ref.picks[n]) for n in ref.picks)
        n_nccl = 0 if bitwise else _same_picks("mesh: nccl picks against detect_picks",
                                               ref.picks, nc["picks"], env_canonical, thr)
        ap = nc["apart"]
        if not ap["cond_bitwise"]:
            fail("mesh: nccl: the step's conditioning is not bitwise the detector's")
        say(
            f"mesh: item 2, the same step on a one-rank NCCL group (rank 0, {nx} channels): "
            f"{nc['wall'] * 1e3:.1f} ms, {nc['launches']} fused_picks launches in "
            f"{nc['attempts']} attempt(s), first and last bitwise plain; picks "
            + ("bitwise detect_picks'" if bitwise else
               f"{n_nccl} apart from detect_picks' on knife edges")
            + f"; collectives {_stats_text(nc['stats'])}; peak {nc['peak'] / 2**30:.2f} GiB")
        say(
            f"mesh: item 2, where the step's filter parts from the one-card detector's "
            f"(f-k engine {ap['fk_engine']}), on the same block: conditioning bitwise; the "
            f"step's f-k transform on the detector's band and mask "
            + ("bitwise the detector's" if ap["transform_bitwise"] else
               f"{ap['transform_rel']:.3e} * max from the detector's")
            + f"; the step's own band {ap['band_step']} (the gain folded in before the "
            f"crop) against the detector's {ap['band_one']}: {ap['crop_rel']:.3e} * max apart")
        # item 3: the time-split long record
        lg = [rk["long"] for rk in ranks]
        lref = _LONG_REF
        long_tiles = {"fused": -(-(nx // MESH_RANKS) // 512),
                      "halo": -(-(MESH_HALO_CHANNELS // MESH_RANKS) // 512)}
        for r in range(MESH_RANKS):
            for name in ("fused", "halo"):
                got = lg[r][name]
                if got["route"] != "fused_picks" or got["launches"] != long_tiles[name]:
                    fail(f"mesh: long record ({name}) rank {r}: picker route {got['route']!r}, "
                         f"{got['launches']} fused_picks launches, expected {long_tiles[name]} "
                         "(one a 512-row tile of its channels)")
                err = max(err, got["kernel_err"])
                launches[f"mesh_long_{name}_rank{r}"] = got["launches"]
                for pn in lg[0][name]["picks"]:
                    if not np.array_equal(lg[r][name]["picks"][pn], lg[0][name]["picks"][pn]):
                        fail(f"mesh: long record ({name}) rank {r}'s picks differ from rank 0's")
        fused, halo = lg[0]["fused"], lg[0]["halo"]
        if fused["n_samples"] != lref["n_samples"]:
            fail(f"mesh: long record of {fused['n_samples']} samples")
        for name, t in lref["thresholds"].items():
            if abs(fused["thresholds"][name] - t) > MESH_THR_RTOL * abs(t):
                fail(f"mesh: long record {name} threshold {fused['thresholds'][name]} "
                     f"against the one-card {t}")
        n_long = _same_picks("mesh: the time-split long record against the one-card one",
                             lref["picks"], fused["picks"], lambda: refs["long_env"],
                             lref["thresholds"])
        for name, res, c in (("fused", fused, ch_s), ("halo", halo, ch_s - h0)):
            if not _picked_near(res["picks"]["HF"], c, lref["onset"], 200.0):
                fail(f"mesh: long record ({name}): the straddling call was not picked")
        say(
            f"mesh: item 3, the long record {nx}x{lref['n_samples']} over a (time=2) mesh (each rank "
            f"reads its own file; the design loaded in {lg[0]['design_load_s']:.1f} s): fused "
            f"bandpass, conditioned wire {fused['wall']:.2f} s (stages "
            f"{json.dumps({k: round(v, 1) for k, v in fused['stages'].items()})} ms), picks "
            f"against the one-card record's: "
            f"{'equal' if n_long == 0 else f'{n_long} apart on knife edges'} (the one-card "
            f"record picks with the plain tiled picker), thresholds "
            f"rtol {MESH_THR_RTOL}; halo bandpass, raw wire, on the {MESH_HALO_CHANNELS} "
            f"channels around the straddling call (the native reader) {halo['wall']:.2f} s, "
            f"{sum(p.shape[1] for p in halo['picks'].values())} picks; the straddling call "
            f"picked by both; the picks through fused_picks (route "
            f"{fused['route']!r}): launches a rank fused {[x['fused']['launches'] for x in lg]}"
            f", halo {[x['halo']['launches'] for x in lg]}, each rank's first and last launch "
            f"({fused['kernel_rows']} and {halo['kernel_rows']} rows x {lref['n_samples']}) "
            f"bitwise plain; collectives rank 0 fused: "
            f"{_stats_text(fused['stats'])}; halo: {_stats_text(halo['stats'])}; peak a rank "
            f"{[round(max(x['fused']['peak'], x['halo']['peak']) / 2**30, 2) for x in lg]} GiB")
        # item 4: the sharded campaign
        cp = [rk["campaign"] for rk in ranks]
        item4 = spec["camp_files"]
        recs = cp[0]["records"]
        if [(s, g) for _, s, g, _ in recs] != [("done", "sharded")] * len(item4):
            fail(f"mesh: campaign records {[(s, g) for _, s, g, _ in recs]}")
        if [x[:3] for x in cp[1]["records"]] != [x[:3] for x in recs]:
            fail("mesh: the ranks returned different campaign records")
        lines = cmod._manifest_path(str(d / "camp"))
        with open(lines) as fh:
            n_lines = sum(1 for ln in fh if ln.strip())
        if n_lines != len(item4):
            fail(f"mesh: the manifest holds {n_lines} lines for {len(item4)} files: only "
                 "rank 0 writes")
        if any(c["resume"] != ["skipped"] * len(item4) or c["resume_reads"] for c in cp):
            fail(f"mesh: resume {[c['resume'] for c in cp]}, reads "
                 f"{[c['resume_reads'] for c in cp]}: it must settle nothing and read nothing")
        if [c["reads"] for c in cp] != [len(item4) // MESH_RANKS] * MESH_RANKS:
            fail(f"mesh: campaign reads a rank {[c['reads'] for c in cp]}")
        findings = fsck.fsck_outdir(str(d / "camp"))
        if findings:
            fail(f"mesh: campaign fsck found {fsck.render_findings(findings)}")
        n_camp = 0
        scenes_by_path = dict(zip(shared["paths"], shared["scenes"]))
        for path, _s, _g, pf in recs:
            got = cmod.load_picks(pf)
            one_picks, one_thr, one_env = refs["camp"][path]
            n_camp += _same_picks(f"mesh: campaign {os.path.basename(path)} against "
                                  "detect_picks", one_picks, got, lambda e=one_env: e, one_thr)
            if _check_calls(scenes_by_path[path], got):
                fail(f"mesh: campaign {os.path.basename(path)}: an injected call was missed")
        for r, c in enumerate(cp):
            launches[f"mesh_campaign_rank{r}"] = c["launches"]
        say(
            f"mesh: item 4, run_campaign_sharded at (file=2, channel=1) over {len(item4)} "
            f"canonical TDMS files (the native reader): {cp[0]['wall']:.1f} s, every file done "
            f"at 'sharded', reads "
            f"a rank {[c['reads'] for c in cp]}, the manifest written by rank 0 alone "
            f"({n_lines} lines), fsck_outdir clean, picks against detect_picks at the files' "
            f"own shape, the native reader too (the campaign phase's run is at the 16384 "
            f"pow2 bucket, another program): "
            f"{'equal' if n_camp == 0 else f'{n_camp} apart on knife edges'}, every "
            f"injected call picked; fused_picks launches a rank "
            f"{[c['launches'] for c in cp]}; resume {cp[0]['resume_wall']:.2f} s, "
            f"{len(item4)} skipped, 0 reads; collectives rank 0: "
            f"{_stats_text(cp[0]['stats'])}; peak a rank "
            f"{[round(c['peak'] / 2**30, 2) for c in cp]} GiB")
        # item 5: the command line, a mesh of one on the card
        t1 = time.perf_counter()
        th.join()
        t_cli_wait = time.perf_counter() - t1
        rc, o, e, _ = cli["sharded"]
        if rc != 0 or "campaign: 1 done, 0 failed" not in o:
            fail(f"mesh: `campaign --sharded` exited {rc}: {o[-800:]} {e[-1500:]}")
        ps, _ = _done_picks(str(d / "cli_sharded"))
        po, tho = refs["cli_one"]
        # the one-device route correlates the 2048 channels at once, the
        # step in 512-row tiles: cuFFT's batches may round apart
        n_cli = _same_picks("mesh: `campaign --sharded` against the one-device detector",
                            po, ps, lambda: refs["cli_env"], tho)
        say(
            f"mesh: item 5, `python -m das4whales_tpu_torch campaign --sharded` without rank "
            f"variables (a mesh of one on the card), {MESH_CLI_CHANNELS} channels of one file, "
            f"designing in-process: exit 0 in {cli['sharded'][3]:.1f} s, picks against the "
            f"one-device detector's (`detect_picks`, the same design) at that selection: "
            f"{'bitwise' if n_cli == 0 else f'{n_cli} apart on knife edges'}, "
            f"{sum(p.shape[1] for p in ps.values())} picks")
        t1 = time.perf_counter()
        stft_launches, stft_err = _mesh_family_checks(ranks, refs, launches, nx, ns)
        err = max(err, stft_launches.pop("_picks_err"))
        t_fam_checks = time.perf_counter() - t1
        t1 = time.perf_counter()
        _mesh_elastic_checks(_mesh_wait(epool, expect_rc={1: 3}), refs, str(d / "elastic"))
        t_elastic_wait = time.perf_counter() - t1
        t_checks = time.perf_counter() - t_checks0
    finally:
        t1 = time.perf_counter()
        shutil.rmtree(d, ignore_errors=True)
        t_rm = time.perf_counter() - t1
    wall = time.perf_counter() - t_phase
    # the family items' seconds (the slower rank's: the ranks run in lockstep)
    # with their checks and the elastic drill's wait after the pool
    fam_s = (max(sum(rk[item]["item_s"] for item in MESH_FAMILY_ITEMS) for rk in ranks)
             + t_fam_checks + t_elastic_wait)
    say(f"mesh: the block and the canonical design's checkpoint written in {t_prep:.1f} s "
        f"while the ranks started (of which {t_designs:.1f} s waiting for the record designs' "
        f"host jobs, whose checkpoints the ranks load), the pool of {MESH_RANKS} ranks {t_pool:.1f} s (the one-card "
        f"references beside it, {refs.get('seconds', 0.0):.1f} s; waited for after the pool "
        f"{t_refs_wait:.1f} s, the command line {t_cli_wait:.1f} s, the elastic drill "
        f"{t_elastic_wait:.1f} s; the checks "
        f"{t_checks:.1f} s, of which the families' {t_fam_checks:.1f} s, the clean-up "
        f"{t_rm:.1f} s); phase {wall:.1f} s, of which the family items 6-11 with their "
        f"checks {fam_s:.1f} s (budgets {MESH_BUDGET_S:.0f} s without them, "
        f"{MESH_FAMILY_BUDGET_S:.0f} s for them)")
    if wall - fam_s > MESH_BUDGET_S:
        fail(f"mesh: the phase less its family items took {wall - fam_s:.1f} s, over its "
             f"{MESH_BUDGET_S:.0f} s budget")
    if fam_s > MESH_FAMILY_BUDGET_S:
        fail(f"mesh: the family items took {fam_s:.1f} s, over their "
             f"{MESH_FAMILY_BUDGET_S:.0f} s budget")
    return launches, err, stft_launches, stft_err


def _mesh_elastic_checks(ranks, refs, outdir: str) -> None:
    """Item 11: the survivor finished every file once at ``sharded`` after
    exactly one ``mesh_downshift`` (2 -> 1), the outdir is ``fsck_outdir``
    clean, and its picks equal ``detect_picks``' at the same channels up
    to knife edges."""
    from das4whales_tpu_torch import fsck
    from das4whales_tpu_torch.utils import artifacts
    from das4whales_tpu_torch.workflows import campaign as cmod

    el = ranks[0]["elastic"]
    recs = el["records"]
    files = list(refs["elastic"])
    if [(p, st, g) for p, st, g, _ in recs] != [(p, "done", "sharded") for p in files]:
        fail(f"mesh: elastic drill: records {[(os.path.basename(p), st, g) for p, st, g, _ in recs]}")
    lines = [r for r in artifacts.read_records(cmod._manifest_path(outdir)) if "path" in r]
    if sorted(r["path"] for r in lines) != sorted(files):
        fail(f"mesh: elastic drill: the manifest holds {len(lines)} file records for "
             f"{len(files)} files")
    downs = [e for e in el["events"] if e["event"] == "mesh_downshift"]
    if len(downs) != 1 or (downs[0]["from_devices"], downs[0]["to_devices"]) != (2, 1):
        fail(f"mesh: elastic drill: mesh_downshift events {downs}")
    findings = fsck.fsck_outdir(outdir)
    if findings:
        fail(f"mesh: elastic drill: fsck found {fsck.render_findings(findings)}")
    n = 0
    for path, _s, _g, pf in recs:
        one_picks, one_thr, env = refs["elastic"][path]
        n += _same_picks(f"mesh: elastic drill {os.path.basename(path)} against detect_picks",
                         one_picks, cmod.load_picks(pf), lambda e=env: e, one_thr)
    say(f"mesh: item 11, the elastic drill: run_campaign_sharded(elastic=True) at (file=1, "
        f"channel=2) over {len(files)} slab files at {MESH_CLI_CHANNELS} channels in batches "
        f"of 2 (its own pool beside the main one), rank 1 exiting as its second batch "
        f"starts: the survivor's check-in waited "
        f"{MESH_ELASTIC_GROUP_TIMEOUT_S + MESH_ELASTIC_DEADLINE_S:.0f} s for it (the pool's "
        f"collective timeout and the probe deadline), one "
        f"mesh_downshift {downs[0]['from_devices']} -> {downs[0]['to_devices']} ("
        f"{downs[0]['error'][:80]}...), the second batch rerun on a mesh of one, every file "
        f"done once at 'sharded' in {el['wall']:.1f} s, fsck_outdir clean, picks against "
        f"detect_picks at those channels: {'equal' if n == 0 else f'{n} apart on knife edges'}")


def _record_knife(label, ref: dict, got: dict, margin_fn, scale: int = 1) -> int:
    """:func:`_same_picks` for a family's long record: picks in samples,
    compared at the positions its margin indexes (``t // scale``, the
    spectro family's frames); ``margin_fn()`` gives ``(names, env, scale,
    thresholds)`` (a ``detect_long_record(keep_envelopes=True)`` run's) and runs only
    where the picks differ. Returns the count of differing picks."""
    from das4whales_tpu_torch.utils.parity import unexplained_differences

    div = np.array([[1], [scale]])
    n, margin = 0, None
    for name in ref:
        a, b = ref[name] // div, got[name] // div
        sa = {tuple(p) for p in a.T.tolist()}
        sb = {tuple(p) for p in b.T.tolist()}
        if sa == sb:
            continue
        if margin is None:
            margin = margin_fn()
        names, env, _, thr = margin
        bad = unexplained_differences(a, b, env[list(names).index(name)], thr[name])
        if bad:
            fail(f"{label}: {name} picks differ beyond rounding at {bad[:10]}")
        n += len(sa ^ sb)
    return n


def _mesh_family_checks(ranks, refs, launches: dict, nx: int, ns: int) -> tuple:
    """Items 6-10 of the mesh phase (module docstring) against their
    one-card references; adds the pick kernel's launches to ``launches``
    and returns ``({path: fused_stft launches, "_picks_err": pick kernel
    error}, fused_stft error)``."""
    from das4whales_tpu_torch.utils.parity import unexplained_learned_differences

    lref = _LONG_REF
    picks_err = stft_err = 0.0
    stft_launches = {}
    # item 6: the channel-sharded spectro step
    sp = [rk["spectro"] for rk in ranks]
    c_local = nx // MESH_RANKS
    n_tiles = -(-c_local // MESH_SPECTRO_TILE)
    last_rows = c_local - (n_tiles - 1) * MESH_SPECTRO_TILE
    for r, s in enumerate(sp):
        if s["launches"] != n_tiles or s["rows"] != [MESH_SPECTRO_TILE, last_rows]:
            fail(f"mesh: spectro rank {r}: {s['launches']} fused_stft launches of "
                 f"{s['rows']} rows (first, last), expected {n_tiles} of "
                 f"[{MESH_SPECTRO_TILE}, {last_rows}]")
        stft_err = max(stft_err, s["err"])
        stft_launches[f"mesh_spectro_rank{r}"] = s["launches"]
        for name in s["picks"]:
            if not np.array_equal(s["picks"][name], sp[0]["picks"][name]):
                fail(f"mesh: spectro rank {r}'s gathered {name} picks differ from rank 0's")
    s_picks, s_corr = refs["spectro"]
    n_sp = _same_picks("mesh: sharded spectro step against SpectroCorrDetector", s_picks,
                       sp[0]["picks"], lambda: np.stack([s_corr[n] for n in s_picks]),
                       {n: 14.0 for n in s_picks})
    say(f"mesh: item 6, make_sharded_spectro_step at (file=1, channel=2) on the prefiltered "
        f"canonical block ({c_local} channels a rank, tiles of {MESH_SPECTRO_TILE}): walls "
        f"{', '.join(f'{s['wall'] * 1e3:.1f}' for s in sp)} ms, fused_stft launches "
        f"{[s['launches'] for s in sp]} (one a tile), each rank's first and last launch "
        f"({sp[0]['rows']} rows) within {max(s['rel'] for s in sp):.2e} * max of plain "
        f"(limit {STFT_REL_TOL}); picks against the one-card SpectroCorrDetector: "
        f"{'equal' if n_sp == 0 else f'{n_sp} apart on knife edges'} "
        f"({sum(p.shape[1] for p in sp[0]['picks'].values())}); peak a rank "
        f"{[round(s['peak'] / 2**30, 2) for s in sp]} GiB")
    # item 7: the file-sharded Gabor step
    gb = [rk["gabor"] for rk in ranks]
    n_gb = 0
    for r, g in enumerate(gb):
        if g["launches"] != 1 or g["kernel_rows"] != [2 * nx, 2 * nx]:
            fail(f"mesh: gabor rank {r}: {g['launches']} fused_picks launches of "
                 f"{g['kernel_rows']} rows, expected one of {2 * nx} (both notes)")
        picks_err = max(picks_err, g["kernel_err"])
        launches[f"mesh_gabor_rank{r}"] = g["launches"]
        one_picks, one_thr, env_fn = refs["gabor"][g["path"]]
        for name, t in one_thr.items():
            got = g["thres"] * (0.9 if name == "HF" else 1.0)
            if abs(got - t) > MESH_THR_RTOL * abs(t):
                fail(f"mesh: gabor rank {r} {name} threshold {got} against GaborDetector's {t}")
        n_gb += _same_picks(f"mesh: gabor rank {r} against GaborDetector", one_picks,
                            g["picks"], env_fn, one_thr)
    say(f"mesh: item 7, make_sharded_gabor_step at (file=2) on two prefiltered slab files "
        f"(each rank reads and filters its own): walls "
        f"{', '.join(f'{g['wall'] * 1e3:.1f}' for g in gb)} ms, one fused_picks launch a "
        f"rank of {gb[0]['kernel_rows'][0]} x {ns}, bitwise plain; thresholds within rtol "
        f"{MESH_THR_RTOL} and picks against GaborDetector's on the same file: "
        f"{'equal' if n_gb == 0 else f'{n_gb} apart on knife edges'} "
        f"({[sum(p.shape[1] for p in g['picks'].values()) for g in gb]}); peak a rank "
        f"{[round(g['peak'] / 2**30, 2) for g in gb]} GiB")
    # item 8: the learned long record over the mesh
    ll = [rk["learned_long"] for rk in ranks]
    one_pk, scores, centers = refs["learned_long"]
    for r, x in enumerate(ll):
        if x["launches"] or x["stft_launches"]:
            fail(f"mesh: learned long record rank {r} launched {x['launches']} / "
                 f"{x['stft_launches']}: its features are the rFFT engine's")
        if not np.array_equal(x["picks"]["CALL"], ll[0]["picks"]["CALL"]):
            fail(f"mesh: learned long record rank {r}'s picks differ from rank 0's")
    bad = unexplained_learned_differences(one_pk, ll[0]["picks"]["CALL"], scores, centers,
                                          0.5, LEARNED_CARD_ABS)
    if bad:
        fail(f"mesh: learned long record against one card: picks differ beyond knife edges "
             f"at {bad[:10]}")
    n_ll = len({tuple(p) for p in one_pk.T.tolist()}
               ^ {tuple(p) for p in ll[0]['picks']['CALL'].T.tolist()})
    if not _picked_near(ll[0]["picks"]["CALL"], lref["ch_s"], lref["onset"] + 68,
                        1.5 * 200.0):
        fail("mesh: learned long record: the straddling call was not picked")
    say(f"mesh: item 8, the learned long record {nx}x{lref['n_samples']} over the mesh, "
        f"channel-sharded at (channel=2) (make_sharded_inference, rFFT features): "
        f"{ll[0]['wall']:.2f} s (stages "
        f"{json.dumps({k: round(v, 1) for k, v in ll[0]['stages'].items()})} ms), no kernel "
        f"launch, picks against the same scoring on one card: "
        f"{'equal' if n_ll == 0 else f'{n_ll} apart on knife edges'} "
        f"({ll[0]['picks']['CALL'].shape[1]}), the straddling call picked; collectives rank "
        f"0: {_stats_text(ll[0]['stats'])}; peak a rank "
        f"{[round(x['peak'] / 2**30, 2) for x in ll]} GiB")
    # items 9 and 10: the spectro and Gabor long records over (time=2)
    for item, fam, sel_key in ((9, "spectro", "spectro_sel"), (10, "gabor", "gabor_sel")):
        fl = [rk[f"{fam}_long"] for rk in ranks]
        one_picks, one_thr, margin_fn = refs[f"{fam}_long"]
        sel = lref[sel_key]
        rows = (sel[1] - sel[0]) // MESH_RANKS
        for r, x in enumerate(fl):
            for name in x["picks"]:
                if not np.array_equal(x["picks"][name], fl[0]["picks"][name]):
                    fail(f"mesh: {fam} long record rank {r}'s picks differ from rank 0's")
            if fam == "gabor":
                if x["launches"] != 1 or x["kernel_rows"] != [2 * rows, 2 * rows]:
                    fail(f"mesh: gabor long record rank {r}: {x['launches']} fused_picks "
                         f"launches of {x.get('kernel_rows')} rows, expected one of {2 * rows}")
                picks_err = max(picks_err, x["kernel_err"])
                launches[f"mesh_gabor_long_rank{r}"] = x["launches"]
            elif x["launches"] or x["stft_launches"]:
                fail(f"mesh: spectro long record rank {r} launched {x['launches']} / "
                     f"{x['stft_launches']}: its frames are rFFT framing")
        got = fl[0]
        for name, t in one_thr.items():
            if abs(got["thresholds"][name] - t) > MESH_THR_RTOL * abs(t):
                fail(f"mesh: {fam} long record {name} threshold {got['thresholds'][name]} "
                     f"against the mesh of one's {t}")
        scale = 8 if fam == "spectro" else 1
        n_fl = _record_knife(f"mesh: {fam} long record over (time=2) against a mesh of one",
                             one_picks, got["picks"], margin_fn, scale)
        if not _picked_near(got["picks"]["HF"], lref["ch_s"] - sel[0], lref["onset"] + 68,
                            1.5 * 200.0):
            fail(f"mesh: {fam} long record: the straddling call was not picked")
        say(f"mesh: item {item}, the {fam} long record over (time=2) on channels "
            f"[{sel[0]}, {sel[1]}) x {lref['n_samples']} (the halo bandpass, the pencil f-k "
            f"on the cut's own mask, the time-split step): {got['wall']:.2f} s (stages "
            f"{json.dumps({k: round(v, 1) for k, v in got['stages'].items()})} ms), picks "
            f"against the same record on a mesh of one on the card: "
            f"{'equal' if n_fl == 0 else f'{n_fl} apart on knife edges'} "
            f"({json.dumps({k: int(v.shape[1]) for k, v in got['picks'].items()})}), "
            f"thresholds rtol {MESH_THR_RTOL}, the straddling call picked"
            + (f"; fused_picks launches a rank {[x['launches'] for x in fl]} of "
               f"{got['kernel_rows'][0]} x {lref['n_samples']}, bitwise plain"
               if fam == "gabor" else "; no kernel launch (rFFT framing, as JAX's)")
            + f"; collectives rank 0: {_stats_text(got['stats'])}; peak a rank "
            f"{[round(x['peak'] / 2**30, 2) for x in fl]} GiB")
    stft_launches["_picks_err"] = picks_err
    return stft_launches, stft_err


def _mesh_alone(d, need_canonical: bool):
    """What the mesh phase takes from earlier phases, made in the host pool
    at once when it runs alone: the slab files, the long record's files,
    designs and one-card picks (``_LONG_REF``), and (returned, where
    asked) the canonical ``(scene, raw block, design)``."""
    import torch

    from das4whales_tpu_torch.io.synth import SyntheticScene, synthesize_scene, to_raw_counts
    from das4whales_tpu_torch.workflows.longrecord import detect_long_record

    nx, nfile = CANONICAL
    pool = _host_pool()
    try:
        jobs, canonical = {}, None
        if "paths" not in _SHARED:
            _SHARED["dir"] = d / "slab"
            _SHARED["dir"].mkdir()
            _EARLY["slab_files"] = pool.submit(_slab_files_job, str(_SHARED["dir"]))
        if not _LONG_REF:
            meta_l = SyntheticScene(nx=nx, ns=LONG_FILES * nfile).metadata
            jobs["long_files"] = pool.submit(_long_files_job, str(d), nx, nfile, SEED + 7)
            for key, rows in (("long_design", nx), ("halo_design", MESH_HALO_CHANNELS),
                              ("spectro_design", MESH_SPECTRO_CHANNELS),
                              ("gabor_design", MESH_GABOR_CHANNELS)):
                jobs[f"{key}_path"] = str(d / f"{key}.npz")
                jobs[key] = pool.submit(_design_job, (rows, LONG_FILES * nfile), meta_l,
                                        path=jobs[f"{key}_path"])
        if need_canonical:
            scene = _scene(nx, nfile, n_calls=6, seed=SEED)
            jobs["design"] = pool.submit(_design_job, (nx, nfile), scene.metadata)
            raw = to_raw_counts(synthesize_scene(scene), scene.metadata)
            canonical = (scene, raw, _loaded(jobs["design"].result())[1])
        slab_files()
        if "long_files" in jobs:
            paths, scene_l, ch_s, onset, _ = jobs["long_files"].result()
            design = _loaded(jobs["long_design"].result())[1]
            r = detect_long_record(paths, [0, nx, 1], interrogator="silixa", design=design,
                                   engine="h5py")
            torch.cuda.synchronize()
            _keep_long_reference(paths, design, scene_l, ch_s, onset, r,
                                 {k: jobs[f"{k}_design"] for k in ("halo", "spectro", "gabor")},
                                 {k: jobs[f"{k}_design_path"]
                                  for k in ("halo", "spectro", "gabor", "long")})
    finally:
        pool.shutdown(cancel_futures=True)
    return canonical


def _keep_long_reference(paths, design, scene, ch_s, onset, res, design_jobs,
                         design_paths) -> None:
    """Keep the one-card long record (conditioned wire) for the mesh phase,
    with the futures of the halo run's ``MESH_HALO_CHANNELS``-channel
    design and the family items' designs (``{"halo", "spectro", "gabor"}``;
    :func:`_long_designs` resolves them), the checkpoints those jobs and
    the record's design wrote (``design_paths``, the ranks load them) and
    the family items' cuts: the files stay until main removes their
    directory."""
    import torch

    from das4whales_tpu_torch.io.stream import stream_strain_blocks

    def env_fn():
        # the knife-edge margin only: the native reader (its float64 demean
        # moves a value by an ulp at most)
        blocks = list(stream_strain_blocks(paths, [0, CANONICAL[0], 1], interrogator="silixa",
                                           as_numpy=True, engine="native"))
        x = torch.as_tensor(np.concatenate([b.trace for b in blocks], axis=-1)).to("cuda")
        return _record_env(x, blocks, design, blocks[0].metadata).cpu().numpy()

    s0 = ch_s - MESH_SPECTRO_CHANNELS // 2
    _LONG_REF.update(paths=list(paths), design=design, ch_s=ch_s, onset=onset,
                     picks=res.picks, thresholds=res.thresholds, n_samples=res.n_samples,
                     env_fn=env_fn, design_jobs=design_jobs, design_paths=design_paths,
                     spectro_sel=[s0, s0 + MESH_SPECTRO_CHANNELS, 1],
                     gabor_sel=[0, MESH_GABOR_CHANNELS, 1])


def _long_designs() -> float:
    """Resolve the mesh phase's record designs into ``_LONG_REF``
    (``halo_design``, ``spectro_design``, ``gabor_design``); returns the
    seconds waited for their host jobs."""
    t0 = time.perf_counter()
    for k, fut in _LONG_REF.pop("design_jobs", {}).items():
        _LONG_REF[f"{k}_design"] = _loaded(fut.result())[1]
    return time.perf_counter() - t0


def phase_mesh_cpu_vs_card():
    """Item 1's step at 512 x 12000: two ranks on the card against two gloo
    CPU ranks, both pools at once (phase 36)."""
    import shutil
    import tempfile
    import threading
    from pathlib import Path

    from das4whales_tpu_torch.io.synth import synthesize_scene, to_raw_counts
    from das4whales_tpu_torch.utils.checkpoint import save_design
    from das4whales_tpu_torch.utils.parity import unexplained_differences

    t_phase = time.perf_counter()
    nx, ns = 512, CANONICAL[1]
    scene = _scene(nx, ns, n_calls=4, seed=SEED + 40)
    raw = to_raw_counts(synthesize_scene(scene), scene.metadata)
    t0 = time.perf_counter()
    _, design = _design_job((nx, ns), scene.metadata)
    t_design = time.perf_counter() - t0
    root = _root_dir() / "build"
    root.mkdir(exist_ok=True)
    d = Path(tempfile.mkdtemp(prefix="mesh_cpu_", dir=root))
    try:
        np.save(d / "raw.npy", raw)
        dpath = save_design(str(d / "design"), design)
        base = dict(world=MESH_RANKS, items=["step"], design=dpath, raw=str(d / "raw.npy"),
                    scale_factor=scene.metadata.scale_factor, metadata=scene.metadata,
                    full_outputs=True)
        out = {}

        def run(tag, dev, threads):
            out[tag] = _mesh_wait(_mesh_pool(d / tag, dict(base, device=dev, threads=threads),
                                             f"mesh_cpu_vs_card ({tag})"))

        ths = [threading.Thread(target=run, args=("card", "cuda:0", 1)),
               threading.Thread(target=run, args=("cpu", "cpu", 3))]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        if set(out) != {"card", "cpu"}:
            fail(f"mesh_cpu_vs_card: pools finished {sorted(out)}")
        card, cpu = out["card"][0]["step"], out["cpu"][0]["step"]
        if cpu["launches"] or not card["launches"]:
            fail(f"mesh_cpu_vs_card: launches card {card['launches']}, cpu {cpu['launches']}")
        rel = {}
        for key in ("trf", "corr"):
            scale = float(np.abs(cpu[key]).max())
            rel[key] = float(np.abs(card[key] - cpu[key]).max()) / scale
            if rel[key] > MESH_CPU_REL:
                fail(f"mesh_cpu_vs_card: {key} {rel[key]:.2e} * max apart (limit {MESH_CPU_REL})")
        thr = {}
        for i, name in enumerate(design.template_names):
            a = float(card["thres"][0]) * float(design.threshold_factors[i])
            b = float(cpu["thres"][0]) * float(design.threshold_factors[i])
            if abs(a - b) > MESH_THR_RTOL * abs(b):
                fail(f"mesh_cpu_vs_card: {name} threshold card {a} cpu {b}")
            thr[name] = b
        n_diff = 0
        for i, name in enumerate(design.template_names):
            bad = unexplained_differences(cpu["picks"][name], card["picks"][name],
                                          cpu["env"][i], thr[name])
            if bad:
                fail(f"mesh_cpu_vs_card: {name} picks differ beyond rounding at {bad[:10]}")
            a = {tuple(p) for p in cpu["picks"][name].T.tolist()}
            b = {tuple(p) for p in card["picks"][name].T.tolist()}
            n_diff += len(a ^ b)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    say(f"mesh_cpu_vs_card: item 1's step at {nx}x{ns} raw int32 over (file=1, channel=2), two "
        f"ranks on the card against two gloo CPU ranks (both pools at once; the design "
        f"{t_design:.1f} s): trf_fk {rel['trf']:.2e} and correlograms {rel['corr']:.2e} * max "
        f"apart (limit {MESH_CPU_REL}), thresholds within rtol {MESH_THR_RTOL}, picks "
        f"{'equal' if n_diff == 0 else f'{n_diff} apart on knife edges'}; card launches "
        f"{card['launches']} a rank, walls card {card['wall'] * 1e3:.1f} ms, cpu "
        f"{cpu['wall'] * 1e3:.1f} ms; collectives card rank 0: {_stats_text(card['stats'])}; "
        f"phase {wall:.1f} s (budget {MESH_CPU_BUDGET_S:.0f} s)")
    if wall > MESH_CPU_BUDGET_S:
        fail(f"mesh_cpu_vs_card: the phase took {wall:.1f} s, over its "
             f"{MESH_CPU_BUDGET_S:.0f} s budget")


#: the analysis phase's gate campaigns: two files of ``ANALYSIS_NX`` x 12000
#: a family, batch 2
ANALYSIS_FILES = ((2070, 12000), (2071, 12000))
ANALYSIS_NX = 512
#: the analysis phase's time target, seconds (a miss is reported, not failed)
ANALYSIS_TARGET_S = 30.0
#: profiler sessions a canonical variant may take to show its launches
ANALYSIS_PROFILER_SESSIONS = 5
#: small kernels a variant's profiler session launches, after its settle
#: and before the variant, so that records the profiler drops at a
#: session's start are not the variant's
PROFILER_WARM_KERNELS = 256


def _profiled_launches(prof) -> dict:
    """``{kernel: launches}`` of the two kernels in a ``torch.profiler``
    session, from its CUDA kernel records."""
    got = {k: 0 for k in KERNELS}
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        for k in KERNELS:
            if f"{k}_kernel" in ev.key:
                got[k] += ev.count
    return got


def _same_campaign_picks(where: str, a, b) -> int:
    """Two campaign results' saved picks bitwise equal, file by file;
    returns the files compared."""
    from das4whales_tpu_torch.workflows.campaign import load_picks

    ref = {r.path: load_picks(r.picks_file) for r in b.records}
    n = 0
    for r in a.records:
        x, y = load_picks(r.picks_file), ref[r.path]
        if r.status != "done" or set(x) != set(y) or any(
                not np.array_equal(x[k], y[k]) for k in x):
            fail(f"{where}: {os.path.basename(r.path)}: picks differ (status {r.status})")
        n += 1
    return n


def phase_analysis(scene=None, raw=None, design=None):
    """The port's own analyzer on the card: the static gate
    (``python -m das4whales_tpu_torch.analysis --check``, exit 0); the
    canonical program variants recorded on the card through the memory
    preflight's probe and audited clean against the checked-in
    ``analysis/contracts.json`` (the CPU's snapshot), each stream's
    ``kernel:*`` entries equal to the launches ``torch.profiler`` saw;
    the contract gate on and off over a batch-2 campaign of each of mf
    and learned at 512 x 12000: picks bitwise, cards ``clean`` against
    ``unchecked``, peaks equal; the recording's cost on a probe's cold wall
    (the canonical mf program at B=1, recorded and not, in turns); a
    second ``detect_picks`` at the canonical shape probing and building
    nothing; both kernels' first and last launch in the phase against
    their plain versions. Returns ``{"launches", "picks_err",
    "stft_err"}``."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch
    from torch.profiler import ProfilerActivity, profile

    from das4whales_tpu_torch.analysis import programs, runtime
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.ops import fused_picks, fused_stft
    from das4whales_tpu_torch.parallel.batch import BatchedMatchedFilterDetector
    from das4whales_tpu_torch.telemetry import costs
    from das4whales_tpu_torch.utils import memory
    from das4whales_tpu_torch.workflows import campaign as cmod

    t_phase = time.perf_counter()
    if design is None:
        scene, raw, design = _canonical_inputs()
    secs = {}
    # -- the static gate, on this machine's Python
    t0 = time.perf_counter()
    gate = subprocess.run([sys.executable, "-m", "das4whales_tpu_torch.analysis", "--check"],
                          capture_output=True, text=True, cwd=str(_root_dir()), timeout=300)
    secs["gate"] = time.perf_counter() - t0
    if gate.returncode != 0:
        fail(f"analysis: the static gate exited {gate.returncode}:\n{gate.stdout[-2000:]}"
             f"\n{gate.stderr[-2000:]}")
    gate_line = (gate.stderr.strip().splitlines() or ["(no summary)"])[-1]
    d = Path(tempfile.mkdtemp(prefix="analysis_", dir=_build_tmp()))
    zero_launches()                      # the phase's main path starts here
    # the launches held against plain are the first and last on data: a
    # probe runs its program on a zero slab (the spectro family normalises
    # it to NaN)
    with _probes_marked() as probes, \
            _capture(fused_picks, "picks_cuda", skip=lambda: probes["active"]) as pcalls, \
            _capture(fused_stft, "stft_power_cuda", skip=lambda: probes["active"]) as scalls, \
            _mxu_table():
        # -- the canonical variants on the card: the gates run while the
        # facades are built, the recording is the probes' own runs
        t0 = time.perf_counter()
        facades = programs.canonical_facades(device="cuda")
        secs["facades"] = time.perf_counter() - t0
        # each variant in a profiler session of its own, so each recorded
        # stream is held against the launches the profiler saw for it; the
        # profiler has dropped the records of a session's first kernels in a
        # long run (PROFILER_SETTLE_S; the learned variant's one fused_stft
        # launch is its first kernel after the probe's zero slab), so each
        # session launches PROFILER_WARM_KERNELS first, and a session that
        # kept fewer launches than the wrapper counted records its variant
        # again, up to ANALYSIS_PROFILER_SESSIONS times
        arts, rec_s, per, sessions = [], [], [], 0
        t0 = time.perf_counter()
        for b, k in facades:
            for attempt in range(ANALYSIS_PROFILER_SESSIONS):
                memory.clear_probe_cache()
                n1 = read_launches()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    time.sleep(PROFILER_SETTLE_S)
                    warm = torch.zeros(1, device="cuda")
                    for _ in range(PROFILER_WARM_KERNELS):
                        warm.add_(1.0)
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    art = programs.record_artifact(b, k)
                    torch.cuda.synchronize()
                    took = time.perf_counter() - t1
                sessions += 1
                counted = {n: c - n1[n] for n, c in read_launches().items() if c > n1[n]}
                seen = {n: c for n, c in _profiled_launches(prof).items() if c}
                if seen == counted:
                    break
            arts.append(art)
            rec_s.append(round(took, 2))
            per.append((art.engine, programs.kernel_entries(art.ops), counted, seen))
        secs["record"] = time.perf_counter() - t0
        secs["sessions"] = sessions
        bad = [p_ for p_ in per if not p_[1] == p_[2] == p_[3]]
        entries = {k: sum(p_[1].get(k, 0) for p_ in per) for k in KERNELS}
        if bad or not all(entries.values()):
            fail("analysis: each recorded stream's kernel entries, the wrapper's launches and "
                 "the profiler's must agree, both kernels launched (engine, entries, "
                 f"launches, profiler): {per}")
        findings = programs.audit_canonical(artifacts=arts)
        if findings:
            fail("analysis: the canonical variants breach their contracts on the card:\n"
                 + "\n".join(f.format() for f in findings))
        snap = programs.load_contracts()
        card = {a.key: programs.op_counts(a.ops) for a in arts}
        drift = {k: (v, snap["programs"].get(k)) for k, v in card.items()
                 if v != snap["programs"].get(k)}
        # -- the contract gate on and off: picks bitwise, verdicts, peaks
        nx = ANALYSIS_NX
        sel = [0, nx, 1]
        paths, fscenes, _ = _write_files(d, ANALYSIS_FILES, nx, n_calls=2)
        meta = fscenes[0].metadata
        t0 = time.perf_counter()
        gate_notes = []
        for fam in ("mf", "learned"):
            got = {}
            # the first run (gate off) makes what the shape caches on the
            # card, which would count in its probe's peak alone: the peaks
            # compared are the second and third runs', each from an emptied
            # allocator cache (a reused cached block counts whole, so the
            # peak above the slab depends on what the cache held)
            for k, on in enumerate((False, True, False)):
                costs.reset()
                memory.clear_probe_cache()
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                (costs.enable_contracts if on else costs.disable_contracts)()
                try:
                    res = cmod.run_campaign_batched(
                        paths, sel, str(d / f"{fam}_{k}"), batch=2, family=fam,
                        cost_cards=True, metadata=meta, interrogator="silixa")
                    got["warm" if k == 0 else on] = (
                        res, [c.as_dict() for c in costs.REGISTRY.cards()])
                finally:
                    costs.enable_contracts()
                    costs.reset()
            n = _same_campaign_picks(f"analysis: {fam} gate on vs off", got[True][0],
                                     got[False][0])
            _same_campaign_picks(f"analysis: {fam} gate on vs the first run", got[True][0],
                                 got["warm"][0])
            v_on = [c["contract"] for c in got[True][1]]
            v_off = [c["contract"] for c in got[False][1]]
            p_on = [c["peak_bytes"] for c in got[True][1]]
            p_off = [c["peak_bytes"] for c in got[False][1]]
            if not v_on or set(v_on) != {"clean"} or set(v_off) != {"unchecked"}:
                fail(f"analysis: {fam} cards' verdicts {v_on} with the gate on, {v_off} off")
            if p_on != p_off or not all(p_on):
                fail(f"analysis: {fam} cards' measured peaks {p_on} with the gate on, "
                     f"{p_off} off")
            gate_notes.append(f"{fam}: {n} files' picks bitwise, cards {v_on} / {v_off}, "
                              f"peaks {[round(p / 2**30, 3) for p in p_on]} GiB both, first "
                              f"runs {[c['compile_seconds'] for c in got[True][1]]} / "
                              f"{[c['compile_seconds'] for c in got[False][1]]} s")
        secs["gate_campaigns"] = time.perf_counter() - t0
        # -- the recording on a cold wall: the canonical mf program at B=1
        det = MatchedFilterDetector.from_design(design, scene.metadata, templates="fin",
                                                wire="raw")
        bdet = BatchedMatchedFilterDetector(det, donate=False)
        walls, peaks, n_ops = {False: [], True: []}, {False: [], True: []}, 0
        t0 = time.perf_counter()
        memory.clear_probe_cache()
        memory.batched_program_memory(bdet, 1, np.int32, capture_ops=False)   # warm-up
        for cap in (False, True, True, False):
            memory.clear_probe_cache()
            torch.cuda.empty_cache()
            an = memory.batched_program_analysis(bdet, 1, np.int32, capture_ops=cap)
            walls[cap].append(an.compile_seconds)
            peaks[cap].append(an.memory.peak)
            n_ops = len(an.ops) if cap else n_ops
        memory.clear_probe_cache()
        secs["recording_ab"] = time.perf_counter() - t0
        if len(set(peaks[False] + peaks[True])) != 1:
            fail(f"analysis: the canonical probe's peak {peaks} changes with recording")
        # -- the compile guard: a second detect_picks probes and builds nothing
        x = torch.as_tensor(raw).to("cuda")
        first, n_first = runtime.count_compiles(det.detect_picks, x)
        second, n_second = runtime.count_compiles(det.detect_picks, x)
        torch.cuda.synchronize()
        if n_second != 0:
            fail(f"analysis: the second detect_picks at {tuple(x.shape)} probed or built "
                 f"{n_second} times")
        if any(not np.array_equal(first.picks[k], second.picks[k]) for k in first.picks):
            fail("analysis: two detect_picks calls on one block picked differently")
        if _check_calls(scene, second.picks):
            fail("analysis: detect_picks missed an injected call")
        del x
    launches = read_launches()
    if not all(launches.values()):
        fail(f"analysis: launches {launches}; both kernels must run in the phase")
    # -- each kernel's first and last launch of the phase against plain
    picks_err, held = 0.0, []
    for which in ("first", "last"):
        (X, thr, K, method, *rest), kw = pcalls[which]
        k_out = fused_picks.picks_cuda(X, thr, K, method, *rest, **kw)
        p_out = fused_picks.picks_plain(X, thr, K, method, *rest, **kw)
        torch.cuda.synchronize()
        picks_err = max(picks_err, _compare(k_out, p_out, "analysis"))
        n_sel = int(k_out.selected.sum())
        held.append(f"{which} pick launch {tuple(X.shape)} {method} K={K}: {n_sel} selected, "
                    "bitwise")
    if n_sel == 0:
        fail("analysis: the last pick launch selected nothing; the comparison proves nothing")
    stft_err, stft_rel, _ = _stft_at_main_path("analysis", scalls,
                                                tuple(scalls["first"][0][0].shape))
    held.append(f"STFT first {tuple(scalls['first'][0][0].shape)} and last "
                f"{tuple(scalls['last'][0][0].shape)} within {stft_rel:.2e} * max")
    del pcalls, scalls
    shutil.rmtree(d, ignore_errors=True)
    total = time.perf_counter() - t_phase
    ms = {c: [round(w * 1e3, 1) for w in walls[c]] for c in walls}
    say(f"analysis ({_SMI.get('line', 'nvidia-smi not read')}): static gate {gate_line} "
        f"({secs['gate']:.1f} s); {len(arts)} canonical variants built in "
        f"{secs['facades']:.1f} s, recorded through the probe, each in a profiler session of "
        f"its own ({secs['sessions']} sessions), in {secs['record']:.1f} s (seconds a "
        f"recording {dict(zip((a.engine for a in arts), rec_s))}) and audited clean "
        f"against contracts.json on the card; each stream's kernel entries = its launches = "
        f"the profiler's, in all {entries}; op counts on the card "
        + (f"differing from the CPU snapshot: {drift}" if drift else "equal to the CPU snapshot")
        + f"; gate on/off ({secs['gate_campaigns']:.1f} s): {'; '.join(gate_notes)}; the "
        f"canonical mf probe at [1, {CANONICAL[0]}, {CANONICAL[1]}] raw: cold walls "
        f"unrecorded {ms[False]} ms, recorded {ms[True]} ms ({n_ops} ops), peak "
        f"{peaks[True][0] / 2**30:.3f} GiB both; second detect_picks: {n_second} probes or "
        f"builds (first {n_first}); launches {launches}; {'; '.join(held)}; phase "
        f"{total:.1f} s (target {ANALYSIS_TARGET_S:.0f} s"
        + (")" if total <= ANALYSIS_TARGET_S else ", MISSED)"))
    return {"launches": launches, "picks_err": picks_err, "stft_err": stft_err}


#: the phases that run in one spawned process beside the card's phases
#: (:func:`beside_start`): first ``dsp`` and ``localize`` at full width, on
#: the canonical block and design this process hands over (their peaks, 15
#: GiB at most, fit beside the learned, preflight and service phases'), then
#: the card-vs-CPU phases, each holding numerics and contracts at 512
#: channels. None shares state with this process. The learned card-vs-CPU
#: phase (it takes the learned phase's scores) and the mesh one (its own
#: pools, under its own budget) stay here
BESIDE_PHASES = ("dsp", "localize", "full_cpu_vs_card", "cpu_vs_card", "spectro_cpu_vs_card",
                 "slab_cpu_vs_card", "campaign_cpu_vs_card", "gabor_cpu_vs_card",
                 "dsp_cpu_vs_card", "localize_cpu_vs_card", "longrecord_cpu_vs_card",
                 "service_cpu_vs_card", "mxu_cpu_vs_card", "workflows_cpu_vs_card")
#: the phases whose results the kernel table reads
BESIDE_RESULTS = ("localize", "slab_cpu_vs_card", "campaign_cpu_vs_card")
#: the full-width beside phases' arguments from the canonical inputs
#: (``scene``, ``raw``, ``design``); ``dsp``'s host designs are this
#: process's jobs (:func:`dsp_host_designs`), so it gets none
BESIDE_ARGS = {"dsp": lambda c: (c["scene"], c["raw"], c["design"], []),
               "localize": lambda c: (c["design"],)}
#: that process's intra-op threads (the card's phases keep the other cores)
BESIDE_CPU_THREADS = 3

#: the beside process: its handle, its pipe and, once sent, its message
_BESIDE: dict = {}


def _beside_canonical(inputs: dict) -> dict:
    """The canonical block and design in the beside process: the scene
    (its metadata), the raw counts and the design from the files
    :func:`beside_start` wrote."""
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDesign
    from das4whales_tpu_torch.utils.checkpoint import load_design

    return {"scene": _scene(*CANONICAL, n_calls=6, seed=SEED), "raw": np.load(inputs["raw"]),
            "design": load_design(inputs["design"], cls=MatchedFilterDesign)}


def _beside_main(tx, names: tuple, threads: int, inputs: dict) -> None:
    """The beside process's body: ``names``' phases in order, on
    ``threads`` intra-op threads (those of :data:`BESIDE_ARGS` on the
    canonical ``inputs``); sends ``("ok", {"results", "seconds"})``,
    ``("fail", None)`` after a failed check (its FAIL line is printed), or
    ``("error", traceback)``."""
    import traceback

    import torch

    from das4whales_tpu_torch.utils.device import disable_tf32

    t0 = time.perf_counter()
    torch.set_num_threads(threads)
    disable_tf32()                       # as the port's entry points in this process
    _time_phases()
    try:
        out = {}
        canonical = None
        last_full = max((i for i, n in enumerate(names) if n in BESIDE_ARGS), default=-1)
        try:
            for i, name in enumerate(names):
                args = ()
                if name in BESIDE_ARGS:
                    canonical = canonical or _beside_canonical(inputs)
                    args = BESIDE_ARGS[name](canonical)
                r = globals()[f"phase_{name}"](*args)
                if name in BESIDE_RESULTS:
                    out[name] = r
                if i == last_full:
                    # the full-width phases are done: give their memory back
                    canonical = None
                    torch.cuda.empty_cache()
        finally:
            workflows_finish()
        msg = ("ok", {"results": out, "seconds": dict(_PHASE_SECONDS),
                      "wall": time.perf_counter() - t0})
    except SystemExit:
        msg = ("fail", None)
    except BaseException:  # noqa: BLE001 — sent to the main process, which fails
        msg = ("error", traceback.format_exc())
    tx.send(msg)
    tx.close()


def beside_start(raw: np.ndarray) -> None:
    """Start :data:`BESIDE_PHASES` in one spawned process on the card: the
    canonical ``raw`` block goes to a file beside the canonical design's
    checkpoint (the early host job's), which that process loads."""
    from multiprocessing import get_context

    if "proc" in _BESIDE:
        return
    inputs = {"raw": str(_build_tmp() / "canonical_raw.npy"),
              "design": str(_build_tmp() / "canonical_design.npz")}
    np.save(inputs["raw"], raw)
    ctx = get_context("spawn")
    rx, tx = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_beside_main,
                       args=(tx, BESIDE_PHASES, BESIDE_CPU_THREADS, inputs),
                       name="smoke-beside")
    proc.start()
    tx.close()
    _BESIDE.update(proc=proc, rx=rx, t0=time.perf_counter())


def _beside_message(block: bool):
    """The beside process's message (None while it runs and ``block`` is
    false); fails the run at once when that process failed."""
    if "msg" not in _BESIDE and (block or _BESIDE["rx"].poll()):
        try:
            _BESIDE["msg"] = _BESIDE["rx"].recv()
        except EOFError:
            _BESIDE["proc"].join()
            _BESIDE["msg"] = ("error", f"exit code {_BESIDE['proc'].exitcode}, no message")
    msg = _BESIDE.get("msg")
    if msg is not None and msg[0] != "ok":
        fail("beside: the card-vs-CPU process failed"
             + (" (its FAIL line above)" if msg[0] == "fail" else f": {msg[1]}"))
    return msg


def beside_check() -> None:
    """Between the card's phases: fail now if the beside process failed."""
    if "proc" in _BESIDE:
        _beside_message(block=False)


def beside_finish() -> dict:
    """Wait for the beside process; its phases' seconds join this
    process's; returns the results of :data:`BESIDE_RESULTS`."""
    t0 = time.perf_counter()
    _, out = _beside_message(block=True)
    _BESIDE["proc"].join()
    _PHASE_SECONDS.update(out["seconds"])
    say(f"beside: {len(BESIDE_PHASES)} phases ({', '.join(BESIDE_ARGS)} at full width, then "
        f"the card-vs-CPU ones) in a spawned process on "
        f"{BESIDE_CPU_THREADS} intra-op threads beside the card's phases: {out['wall']:.1f} s "
        f"in that process ({sum(out['seconds'].values()):.1f} s of phases), started "
        f"{time.perf_counter() - _BESIDE['t0']:.1f} s before this line; waited "
        f"{time.perf_counter() - t0:.1f} s for it here")
    _BESIDE.clear()
    return out["results"]


def beside_stop() -> None:
    """On the way out of a failed run: stop the beside process."""
    proc = _BESIDE.pop("proc", None)
    if proc is not None and proc.is_alive():
        proc.kill()
        proc.join()
    _BESIDE.clear()


def _time_phases() -> None:
    """Wrap every ``phase_*`` function so that its seconds are kept."""
    for name, fn in list(globals().items()):
        if name.startswith("phase_") and callable(fn):
            def timed(*a, _fn=fn, _name=name[len("phase_"):], **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    _PHASE_SECONDS[_name] = round(
                        _PHASE_SECONDS.get(_name, 0.0) + time.perf_counter() - t0, 1)

            globals()[name] = functools.wraps(fn)(timed)


def main(argv: list) -> int:
    if argv[:1] == ["--mesh-rank"]:
        # one rank of a mesh phase's pool, started by _mesh_pool
        return mesh_rank_main(argv[1], int(argv[2]))
    import torch

    _time_phases()

    if argv[:1] == ["--only"]:
        # a development run of the named phases after device and build, e.g.
        # --only campaign,campaign_cpu_vs_card; it prints no result line
        phase_device()
        phase_build()
        try:
            for name in argv[1].split(","):
                globals()[f"phase_{name}"]()
            serve_start()
            serve_finish()
        finally:
            if "proc" in _SERVE:
                _SERVE["proc"].kill()
                _SERVE["proc"].wait()
            remove_slab_files()
            workflows_finish()
        say(f"phase seconds: {json.dumps(_PHASE_SECONDS)}")
        return 0
    if argv:
        fail(f"unknown arguments {argv}; run with none, or --only PHASE[,PHASE]")
    t_start = time.perf_counter()
    smi_line = phase_device()
    pool = _host_pool()
    prep = None
    try:
        # the detect phase's design, on one host core beside the build and
        # the kernels phase (it took 35.6 s of the detect phase's set-up)
        _EARLY["canonical_design"] = pool.submit(
            _design_job, CANONICAL, _scene(*CANONICAL, n_calls=6, seed=SEED).metadata,
            path=str(_build_tmp() / "canonical_design.npz"))
        phase_build()
        kern, err = phase_kernels()
        # the slab files and two designs are made on the host beside the
        # detect phase's set-up, the long record's files and design beside
        # the later phases
        early_host_jobs(pool)
        # the analysis phase runs inside the detect phase, while that phase
        # waits for the early host jobs (its seconds are its own, not
        # detect's)
        analysis_out = {}
        launches, scene, raw, design = phase_detect(
            lambda s_, r_, d_: analysis_out.update(phase_analysis(s_, r_, d_)))
        _PHASE_SECONDS["detect"] = round(_PHASE_SECONDS["detect"]
                                         - _PHASE_SECONDS.get("analysis", 0.0), 1)
        full_launches, full_err, _ = phase_full(scene, raw, design)
        phase_channel_pad(scene, raw, design)
        bank_launches, bank_err, _ = phase_bank(scene, raw, design)
        stft, stft_err = phase_stft_kernel()
        stft_launches = phase_spectro(scene, raw, design)
        slab_launches, slab_picks_err = phase_slab()
        campaign_launches = phase_campaign()
        gabor_launches, gabor_campaign_launches, gabor_err, _ = phase_gabor(scene, raw, design)
        # from here, once the gabor phase's 66 GiB batched peak is given
        # back, the dsp and localize phases and then the card-vs-CPU phases
        # run in a process of their own and the mains and the command line
        # in theirs, beside the card's phases (a cut for the run's time
        # limit)
        workflows_start()
        beside_start(raw)
        learned_launches, learned_err, learned = phase_learned(scene, raw)
        phase_learned_cpu_vs_card(learned["card"])
        beside_check()
        # the long record's files and designs and the dsp phase's f-k
        # designs, on the host beside the preflight, service and fleet
        # phases
        prep = long_record_prep(pool)
        host_designs = dsp_host_designs(scene, pool)
        phase_preflight()
        svc_launches, (svc_picks_err, svc_stft_err) = phase_service()
        # the serve verb's subprocess beside the fleet phase; waited for
        # before the long record's peak
        serve_start()
        beside_check()
        phase_fleet(svc_launches["fused_picks"])
        serve_finish()
        # the mains' process is done long before: it goes, with the memory
        # its allocator holds, before the long record's peak
        wf_out = phase_workflows()
        workflows_reap()
        long_launches, long_err, long_picks_launches, long_picks_err = phase_longrecord(
            prep, design)
        # every process beside this one ends before the mesh's ranks share
        # the card
        beside = beside_finish()
        mesh_launches, mesh_err, mesh_stft_launches, mesh_stft_err = phase_mesh(scene, raw,
                                                                                design)
        mxu_out = phase_mxu(scene, raw, design)
        del scene, raw, design
        report_host_designs(host_designs)
        pool.shutdown(cancel_futures=True)
        # last, with every process beside this one done: its two CPU ranks
        # run under the phase's own budget
        phase_mesh_cpu_vs_card()
        loc_launches, loc_err = beside["localize"]
        slab_stft_launches, slab_stft_err = beside["slab_cpu_vs_card"]
        campaign_stft_launches, campaign_stft_err = beside["campaign_cpu_vs_card"]
    except BaseException:
        beside_stop()
        raise
    finally:
        import shutil

        pool.shutdown(cancel_futures=True)
        if prep is not None:
            shutil.rmtree(prep["dir"], ignore_errors=True)
        if "tmp" in _HOST_TMP:
            shutil.rmtree(_HOST_TMP.pop("tmp"), ignore_errors=True)
        workflows_finish()
        if "proc" in _SERVE:
            _SERVE["proc"].kill()
            _SERVE["proc"].wait()
        # the serve subprocess and the mesh phase read them
        remove_slab_files()
    say(f"phase seconds: {json.dumps(_PHASE_SECONDS)}")
    pk = kern["pack"]
    print(json.dumps({"kernels": [{
        "name": "fused_picks",
        "route": "cuda",
        "source": "das4whales_tpu_torch/csrc/fused_picks.cu",
        "replaces": "das4whales_tpu/ops/pallas_picks.py:71",
        "launches": launches,
        "launches_by_path": {"detect": launches, "full": full_launches, "bank": bank_launches,
                             "slab_batched": slab_launches["batched"],
                             "slab_serial": slab_launches["serial"],
                             "campaign": campaign_launches, "gabor": gabor_launches,
                             "campaign_gabor": gabor_campaign_launches, **loc_launches,
                             "service": svc_launches["fused_picks"],
                             "mxu": mxu_out["launches"], **wf_out["launches"],
                             "analysis": analysis_out["launches"]["fused_picks"],
                             **long_picks_launches, **mesh_launches},
        "max_abs_err": max(err, slab_picks_err, full_err, bank_err, gabor_err, loc_err,
                           _PREFLIGHT["picks_err"], svc_picks_err, mxu_out["err"],
                           wf_out["err"], long_picks_err, mesh_err, analysis_out["picks_err"]),
        "ms": pk["ms"],
        "device_ms": pk["device_ms"],
        "plain_ms": pk["plain_ms"],
        "bound_ms": pk["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "fused_stft",
        "route": "cuda",
        "source": "das4whales_tpu_torch/csrc/fused_stft.cu",
        "replaces": "das4whales_tpu/ops/pallas_stft.py:71",
        "launches": stft_launches,
        "launches_by_path": {"spectro": stft_launches, "slab_spectro": slab_stft_launches,
                             "campaign_spectro": campaign_stft_launches, **learned_launches,
                             **long_launches, "service": svc_launches["fused_stft"],
                             "mxu_calibrate_stft": mxu_out["stft_launches"],
                             **wf_out["stft_launches"], **mesh_stft_launches,
                             "analysis": analysis_out["launches"]["fused_stft"]},
        "max_abs_err": max(stft_err, slab_stft_err, campaign_stft_err, learned_err, long_err,
                           svc_stft_err, mxu_out["stft_err"], wf_out["stft_err"],
                           mesh_stft_err, analysis_out["stft_err"]),
        "ms": stft["ms"],
        "device_ms": stft["device_ms"],
        "plain_ms": stft["plain_ms"],
        "bound_ms": stft["bound_ms"],
        "bound_by": stft["bound_by"],
        "library_ms": stft["library_ms"],
    }]}))
    say(f"total: {time.perf_counter() - t_start:.1f} s, the kernels' builds included")
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
