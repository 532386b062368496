/* A self-contained LADSPA plugin library used by the gstbad LADSPA
 * host (gstbad/io/ladspa.py) and its tests.
 *
 * The environment ships no LADSPA plugins, so this file provides the
 * fixtures the reference's ladspa element family
 * (ext/ladspa/gstladspa.c) would wrap.  It implements the public
 * LADSPA 1.1 plugin ABI from its specification (ladspa.org) — the
 * type and constant declarations below are rewritten from the spec,
 * not copied from a header.
 *
 * Four plugins, chosen to exercise every host feature:
 *   amp_mono   - 1 audio in / 1 audio out, float "Gain" control
 *                (bounded 0..10, DEFAULT_1, logarithmic)
 *   amp_stereo - 2 in / 2 out, shared gain + TOGGLED "Mute" +
 *                INTEGER "Delay Samples" (exercises property types
 *                and interleaving)
 *   sine_osc   - source (0 in / 1 out): "Frequency (Hz)" with
 *                SAMPLE_RATE + DEFAULT_440 hints, "Amplitude"
 *                DEFAULT_MAXIMUM; keeps phase across run() calls
 *   peak_meter - sink (1 in / 0 out): control OUTPUT port "Peak"
 *                (running maximum of |x|)
 */

#include <stdlib.h>
#include <string.h>
#include <math.h>

/* ---- LADSPA ABI (from the public specification) ------------------- */

typedef float LADSPA_Data;
typedef int LADSPA_Properties;
typedef int LADSPA_PortDescriptor;
typedef int LADSPA_PortRangeHintDescriptor;
typedef void *LADSPA_Handle;

#define LADSPA_PORT_INPUT    0x1
#define LADSPA_PORT_OUTPUT   0x2
#define LADSPA_PORT_CONTROL  0x4
#define LADSPA_PORT_AUDIO    0x8

#define LADSPA_HINT_BOUNDED_BELOW   0x001
#define LADSPA_HINT_BOUNDED_ABOVE   0x002
#define LADSPA_HINT_TOGGLED         0x004
#define LADSPA_HINT_SAMPLE_RATE     0x008
#define LADSPA_HINT_LOGARITHMIC     0x010
#define LADSPA_HINT_INTEGER         0x020
#define LADSPA_HINT_DEFAULT_MINIMUM 0x040
#define LADSPA_HINT_DEFAULT_LOW     0x080
#define LADSPA_HINT_DEFAULT_MIDDLE  0x0C0
#define LADSPA_HINT_DEFAULT_HIGH    0x100
#define LADSPA_HINT_DEFAULT_MAXIMUM 0x140
#define LADSPA_HINT_DEFAULT_0       0x200
#define LADSPA_HINT_DEFAULT_1       0x240
#define LADSPA_HINT_DEFAULT_100     0x280
#define LADSPA_HINT_DEFAULT_440     0x2C0

typedef struct {
  LADSPA_PortRangeHintDescriptor HintDescriptor;
  LADSPA_Data LowerBound;
  LADSPA_Data UpperBound;
} LADSPA_PortRangeHint;

typedef struct _LADSPA_Descriptor {
  unsigned long UniqueID;
  const char *Label;
  LADSPA_Properties Properties;
  const char *Name;
  const char *Maker;
  const char *Copyright;
  unsigned long PortCount;
  const LADSPA_PortDescriptor *PortDescriptors;
  const char *const *PortNames;
  const LADSPA_PortRangeHint *PortRangeHints;
  void *ImplementationData;
  LADSPA_Handle (*instantiate) (const struct _LADSPA_Descriptor *,
                                unsigned long sample_rate);
  void (*connect_port) (LADSPA_Handle, unsigned long port,
                        LADSPA_Data *location);
  void (*activate) (LADSPA_Handle);
  void (*run) (LADSPA_Handle, unsigned long sample_count);
  void (*run_adding) (LADSPA_Handle, unsigned long sample_count);
  void (*set_run_adding_gain) (LADSPA_Handle, LADSPA_Data gain);
  void (*deactivate) (LADSPA_Handle);
  void (*cleanup) (LADSPA_Handle);
} LADSPA_Descriptor;

/* ---- common instance ------------------------------------------------ */

#define MAX_PORTS 8

typedef struct {
  LADSPA_Data *ports[MAX_PORTS];
  unsigned long rate;
  double phase;       /* sine_osc */
  LADSPA_Data peak;   /* peak_meter */
} Instance;

static LADSPA_Handle
instantiate (const LADSPA_Descriptor *desc, unsigned long rate)
{
  Instance *in = (Instance *) calloc (1, sizeof (Instance));
  if (in)
    in->rate = rate;
  return in;
}

static void
connect_port (LADSPA_Handle h, unsigned long port, LADSPA_Data *loc)
{
  if (port < MAX_PORTS)
    ((Instance *) h)->ports[port] = loc;
}

static void
cleanup (LADSPA_Handle h)
{
  free (h);
}

/* ---- amp_mono: ports 0=Gain(ctl in) 1=Input 2=Output ---------------- */

static void
amp_mono_run (LADSPA_Handle h, unsigned long n)
{
  Instance *in = (Instance *) h;
  LADSPA_Data gain = *in->ports[0];
  unsigned long i;
  for (i = 0; i < n; i++)
    in->ports[2][i] = in->ports[1][i] * gain;
}

static const LADSPA_PortDescriptor amp_mono_pdesc[] = {
  LADSPA_PORT_INPUT | LADSPA_PORT_CONTROL,
  LADSPA_PORT_INPUT | LADSPA_PORT_AUDIO,
  LADSPA_PORT_OUTPUT | LADSPA_PORT_AUDIO,
};
static const char *const amp_mono_pnames[] = { "Gain", "Input", "Output" };
static const LADSPA_PortRangeHint amp_mono_phints[] = {
  {LADSPA_HINT_BOUNDED_BELOW | LADSPA_HINT_BOUNDED_ABOVE |
        LADSPA_HINT_LOGARITHMIC | LADSPA_HINT_DEFAULT_1, 0.01f, 10.0f},
  {0, 0, 0},
  {0, 0, 0},
};

/* ---- amp_stereo: 0=Gain 1=Mute 2=Delay 3=InL 4=InR 5=OutL 6=OutR --- */

static void
amp_stereo_run (LADSPA_Handle h, unsigned long n)
{
  Instance *in = (Instance *) h;
  LADSPA_Data gain = *in->ports[0];
  int mute = *in->ports[1] > 0.5f;
  unsigned long i;
  if (mute)
    gain = 0.0f;
  for (i = 0; i < n; i++) {
    in->ports[5][i] = in->ports[3][i] * gain;
    in->ports[6][i] = in->ports[4][i] * gain;
  }
}

static const LADSPA_PortDescriptor amp_stereo_pdesc[] = {
  LADSPA_PORT_INPUT | LADSPA_PORT_CONTROL,
  LADSPA_PORT_INPUT | LADSPA_PORT_CONTROL,
  LADSPA_PORT_INPUT | LADSPA_PORT_CONTROL,
  LADSPA_PORT_INPUT | LADSPA_PORT_AUDIO,
  LADSPA_PORT_INPUT | LADSPA_PORT_AUDIO,
  LADSPA_PORT_OUTPUT | LADSPA_PORT_AUDIO,
  LADSPA_PORT_OUTPUT | LADSPA_PORT_AUDIO,
};
static const char *const amp_stereo_pnames[] =
    { "Gain", "Mute", "Delay Samples", "Input (Left)", "Input (Right)",
  "Output (Left)", "Output (Right)"
};
static const LADSPA_PortRangeHint amp_stereo_phints[] = {
  {LADSPA_HINT_BOUNDED_BELOW | LADSPA_HINT_BOUNDED_ABOVE |
        LADSPA_HINT_DEFAULT_MIDDLE, 0.0f, 4.0f},
  {LADSPA_HINT_TOGGLED, 0, 0},
  {LADSPA_HINT_BOUNDED_BELOW | LADSPA_HINT_BOUNDED_ABOVE |
        LADSPA_HINT_INTEGER | LADSPA_HINT_DEFAULT_0, 0.0f, 64.0f},
  {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0},
};

/* ---- sine_osc: 0=Frequency 1=Amplitude 2=Output --------------------- */

static void
sine_osc_run (LADSPA_Handle h, unsigned long n)
{
  Instance *in = (Instance *) h;
  double freq = *in->ports[0];
  LADSPA_Data amp = *in->ports[1];
  double step = 2.0 * M_PI * freq / (double) in->rate;
  unsigned long i;
  for (i = 0; i < n; i++) {
    in->ports[2][i] = (LADSPA_Data) (amp * sin (in->phase));
    in->phase += step;
  }
  if (in->phase > 2.0 * M_PI)
    in->phase = fmod (in->phase, 2.0 * M_PI);
}

static void
sine_osc_activate (LADSPA_Handle h)
{
  ((Instance *) h)->phase = 0.0;
}

static const LADSPA_PortDescriptor sine_osc_pdesc[] = {
  LADSPA_PORT_INPUT | LADSPA_PORT_CONTROL,
  LADSPA_PORT_INPUT | LADSPA_PORT_CONTROL,
  LADSPA_PORT_OUTPUT | LADSPA_PORT_AUDIO,
};
static const char *const sine_osc_pnames[] =
    { "Frequency (Hz)", "Amplitude", "Output" };
static const LADSPA_PortRangeHint sine_osc_phints[] = {
  /* SAMPLE_RATE-relative bounds, default 440 Hz */
  {LADSPA_HINT_BOUNDED_BELOW | LADSPA_HINT_BOUNDED_ABOVE |
        LADSPA_HINT_SAMPLE_RATE | LADSPA_HINT_DEFAULT_440,
      0.0f, 0.5f},
  {LADSPA_HINT_BOUNDED_BELOW | LADSPA_HINT_BOUNDED_ABOVE |
        LADSPA_HINT_DEFAULT_MAXIMUM, 0.0f, 1.0f},
  {0, 0, 0},
};

/* ---- peak_meter: 0=Input 1=Peak(ctl out) ---------------------------- */

static void
peak_meter_run (LADSPA_Handle h, unsigned long n)
{
  Instance *in = (Instance *) h;
  unsigned long i;
  LADSPA_Data peak = in->peak;
  for (i = 0; i < n; i++) {
    LADSPA_Data v = fabsf (in->ports[0][i]);
    if (v > peak)
      peak = v;
  }
  in->peak = peak;
  *in->ports[1] = peak;
}

static void
peak_meter_activate (LADSPA_Handle h)
{
  ((Instance *) h)->peak = 0.0f;
}

static const LADSPA_PortDescriptor peak_meter_pdesc[] = {
  LADSPA_PORT_INPUT | LADSPA_PORT_AUDIO,
  LADSPA_PORT_OUTPUT | LADSPA_PORT_CONTROL,
};
static const char *const peak_meter_pnames[] = { "Input", "Peak" };
static const LADSPA_PortRangeHint peak_meter_phints[] = {
  {0, 0, 0},
  {LADSPA_HINT_BOUNDED_BELOW, 0.0f, 0.0f},
};

/* ---- descriptors ----------------------------------------------------- */

static const LADSPA_Descriptor descriptors[] = {
  {4801, "amp_mono", 0, "GstBad Test Mono Amplifier", "gstbad",
        "ISC", 3, amp_mono_pdesc, amp_mono_pnames, amp_mono_phints,
        NULL, instantiate, connect_port, NULL, amp_mono_run, NULL,
      NULL, NULL, cleanup},
  {4802, "amp_stereo", 0, "GstBad Test Stereo Amplifier", "gstbad",
        "ISC", 7, amp_stereo_pdesc, amp_stereo_pnames,
        amp_stereo_phints, NULL, instantiate, connect_port, NULL,
      amp_stereo_run, NULL, NULL, NULL, cleanup},
  {4803, "sine_osc", 0, "GstBad Test Sine Oscillator", "gstbad",
        "ISC", 3, sine_osc_pdesc, sine_osc_pnames, sine_osc_phints,
        NULL, instantiate, connect_port, sine_osc_activate,
      sine_osc_run, NULL, NULL, NULL, cleanup},
  {4804, "peak_meter", 0, "GstBad Test Peak Meter", "gstbad",
        "ISC", 2, peak_meter_pdesc, peak_meter_pnames,
        peak_meter_phints, NULL, instantiate, connect_port,
      peak_meter_activate, peak_meter_run, NULL, NULL, NULL, cleanup},
};

const LADSPA_Descriptor *
ladspa_descriptor (unsigned long index)
{
  if (index < sizeof (descriptors) / sizeof (descriptors[0]))
    return &descriptors[index];
  return NULL;
}
